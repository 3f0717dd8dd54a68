"""Pure-Python ELF symbol reader + process-address symbolizer.

Reference: src/stirling/obj_tools/elf_reader.cc — iterate .symtab/.dynsym,
resolve addresses to function symbols (profiler symbolization), and check
symbol existence (dynamic-trace target validation).  The reference links
LLVM's object libraries; the wire format itself (ELF spec) is small enough
to parse directly, which keeps this dependency-free.

Covers ELF64 + ELF32, little/big endian, FUNC/OBJECT symbols from both
.symtab (full, when unstripped) and .dynsym (exported, always present in
shared objects), and PIE/vaddr-bias handling for live-process symbolization
via /proc/<pid>/maps.

Copied from the reference package (pixie_tpu/obj_tools/elf_reader.py).
"""
from __future__ import annotations

import bisect
import dataclasses
import struct
from typing import Optional

# e_ident offsets
_EI_CLASS = 4
_EI_DATA = 5
_ELFCLASS32, _ELFCLASS64 = 1, 2
_ELFDATA2LSB = 1

# section types
_SHT_SYMTAB = 2
_SHT_STRTAB = 3
_SHT_DYNSYM = 11

# symbol types (st_info low nibble)
STT_OBJECT = 1
STT_FUNC = 2

# program header
_PT_LOAD = 1
_PF_X = 1


@dataclasses.dataclass(frozen=True)
class ElfSymbol:
    name: str
    addr: int
    size: int
    stype: int  # STT_*

    @property
    def is_func(self) -> bool:
        return self.stype == STT_FUNC


class ElfReader:
    """Parse an ELF file's symbols (reference elf_reader.cc ElfReader)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.data = f.read()
        d = self.data
        if d[:4] != b"\x7fELF":
            raise ValueError(f"{path}: not an ELF file")
        self.is64 = d[_EI_CLASS] == _ELFCLASS64
        self.little = d[_EI_DATA] == _ELFDATA2LSB
        self._end = "<" if self.little else ">"
        if self.is64:
            (self.e_type, self.e_machine, _ver, self.e_entry, self.e_phoff,
             self.e_shoff, _flags, _ehsize, self.e_phentsize, self.e_phnum,
             self.e_shentsize, self.e_shnum, self.e_shstrndx) = struct.unpack(
                self._end + "HHIQQQIHHHHHH", d[16:64])
        else:
            (self.e_type, self.e_machine, _ver, self.e_entry, self.e_phoff,
             self.e_shoff, _flags, _ehsize, self.e_phentsize, self.e_phnum,
             self.e_shentsize, self.e_shnum, self.e_shstrndx) = struct.unpack(
                self._end + "HHIIIIIHHHHHH", d[16:52])
        self._sections = self._read_sections()
        self._symbols: Optional[list[ElfSymbol]] = None
        self._by_addr: Optional[tuple[list[int], list[ElfSymbol]]] = None
        self._min_load: Optional[int] = None

    # ------------------------------------------------------------- sections
    def _read_sections(self) -> list[dict]:
        d = self.data
        out = []
        fmt = (self._end + "IIQQQQIIQQ") if self.is64 else (self._end + "IIIIIIIIII")
        sz = struct.calcsize(fmt)
        for i in range(self.e_shnum):
            off = self.e_shoff + i * self.e_shentsize
            if off + sz > len(d):
                break
            (name, stype, flags, addr, offset, size, link, info, align,
             entsize) = struct.unpack(fmt, d[off: off + sz])
            out.append(dict(name=name, type=stype, addr=addr, offset=offset,
                            size=size, link=link, entsize=entsize))
        return out

    def _strtab(self, idx: int) -> bytes:
        s = self._sections[idx]
        return self.data[s["offset"]: s["offset"] + s["size"]]

    @staticmethod
    def _str_at(tab: bytes, off: int) -> str:
        end = tab.find(b"\x00", off)
        return tab[off:end].decode("utf-8", "replace") if end >= 0 else ""

    # -------------------------------------------------------------- symbols
    def symbols(self) -> list[ElfSymbol]:
        """FUNC/OBJECT symbols from .symtab + .dynsym (deduped by name+addr).
        File virtual addresses (subtract the load bias for live processes)."""
        if self._symbols is not None:
            return self._symbols
        out: dict[tuple, ElfSymbol] = {}
        sym_fmt = (self._end + "IBBHQQ") if self.is64 else (self._end + "IIIBBH")
        sym_sz = struct.calcsize(sym_fmt)
        for sec in self._sections:
            if sec["type"] not in (_SHT_SYMTAB, _SHT_DYNSYM):
                continue
            strtab = self._strtab(sec["link"])
            n = sec["size"] // max(sec["entsize"] or sym_sz, 1)
            for i in range(n):
                off = sec["offset"] + i * (sec["entsize"] or sym_sz)
                raw = self.data[off: off + sym_sz]
                if len(raw) < sym_sz:
                    break
                if self.is64:
                    name_off, info, _other, shndx, value, size = struct.unpack(
                        sym_fmt, raw)
                else:
                    name_off, value, size, info, _other, shndx = struct.unpack(
                        sym_fmt, raw)
                stype = info & 0xF
                if stype not in (STT_FUNC, STT_OBJECT) or value == 0:
                    continue
                name = self._str_at(strtab, name_off)
                if not name:
                    continue
                out[(name, value)] = ElfSymbol(name, value, size, stype)
        self._symbols = sorted(out.values(), key=lambda s: s.addr)
        return self._symbols

    def symbol(self, name: str) -> Optional[ElfSymbol]:
        for s in self.symbols():
            if s.name == name:
                return s
        return None

    def has_symbol(self, name: str) -> bool:
        return self.symbol(name) is not None

    def symbolize(self, addr: int) -> Optional[str]:
        """File-virtual address → containing function symbol name."""
        if self._by_addr is None:
            funcs = [s for s in self.symbols() if s.is_func]
            self._by_addr = ([s.addr for s in funcs], funcs)
        addrs, funcs = self._by_addr
        i = bisect.bisect_right(addrs, addr) - 1
        if i < 0:
            return None
        s = funcs[i]
        if s.size and addr >= s.addr + s.size:
            return None
        return s.name

    # ---------------------------------------------------------- load bias
    def min_load_vaddr(self) -> int:
        """Lowest PT_LOAD vaddr — the reference point for PIE bias.
        Memoized: symbolize() consults it per frame on the profiler's
        ingest path."""
        if self._min_load is not None:
            return self._min_load
        d = self.data
        fmt = (self._end + "IIQQQQQQ") if self.is64 else (self._end + "IIIIIIII")
        sz = struct.calcsize(fmt)
        lo = None
        for i in range(self.e_phnum):
            off = self.e_phoff + i * self.e_phentsize
            raw = d[off: off + sz]
            if len(raw) < sz:
                break
            if self.is64:
                ptype, _fl, _off, vaddr, _pa, _fsz, _msz, _al = struct.unpack(
                    fmt, raw)
            else:
                ptype, _off, vaddr, _pa, _fsz, _msz, _fl, _al = struct.unpack(
                    fmt, raw)
            if ptype == _PT_LOAD:
                lo = vaddr if lo is None else min(lo, vaddr)
        self._min_load = lo or 0
        return self._min_load


class NativeSymbolizer:
    """Live-process address symbolization via /proc/<pid>/maps + ElfReader.

    Reference: perf_profiler/symbolizers/ (ELF symbolization of native
    frames).  Maps a runtime address to (binary, symbol) by finding the
    containing executable mapping, loading its ELF symbols, and subtracting
    the mapping's load bias.
    """

    def __init__(self, pid: int = 0):
        import os

        self.pid = pid or os.getpid()
        #: [(start, end, file_page_offset, path)]
        self.maps: list[tuple[int, int, int, str]] = []
        self._readers: dict[str, Optional[ElfReader]] = {}
        self.reload_maps()

    def reload_maps(self) -> None:
        self.maps = []
        try:
            with open(f"/proc/{self.pid}/maps") as f:
                lines = f.read().splitlines()
        except OSError:
            return
        for line in lines:
            parts = line.split()
            if len(parts) < 6 or "x" not in parts[1]:
                continue
            path = parts[5]
            if not path.startswith("/"):
                continue
            lo, hi = (int(x, 16) for x in parts[0].split("-"))
            file_off = int(parts[2], 16)
            self.maps.append((lo, hi, file_off, path))

    def _reader(self, path: str) -> Optional[ElfReader]:
        if path not in self._readers:
            try:
                self._readers[path] = ElfReader(path)
            except (OSError, ValueError):
                self._readers[path] = None
        return self._readers[path]

    def symbolize(self, addr: int) -> str:
        """Runtime address → 'symbol (binary)' or the hex address."""
        for lo, hi, file_off, path in self.maps:
            if lo <= addr < hi:
                rd = self._reader(path)
                if rd is None:
                    break
                # runtime→file vaddr: undo the mapping bias.  The segment at
                # file offset `file_off` maps at `lo`; ELF vaddrs differ from
                # file offsets by a per-segment constant that PT_LOAD
                # alignment makes equal to (vaddr - offset) — recovered from
                # the lowest load vaddr for the common contiguous layout.
                fvaddr = addr - lo + file_off + rd.min_load_vaddr() \
                    if rd.e_type == 3 else addr  # ET_DYN (PIE/so) vs ET_EXEC
                name = rd.symbolize(fvaddr)
                if name:
                    short = path.rsplit("/", 1)[-1]
                    return f"{name} ({short})"
                break
        return hex(addr)
