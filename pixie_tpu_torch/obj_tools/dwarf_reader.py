"""Minimal pure-Python DWARF reader: function argument locations + sizes.

Reference: src/stirling/obj_tools/dwarf_reader.cc (LLVM-based) — feeds the
dynamic tracer's "dwarvifier" pass, which turns logical probe arg captures
into physical memory reads (dynamic_tracing/dwarvifier.cc), and enriches
profiler symbolization.  This reader covers exactly what probe codegen
needs: for a named function, each formal parameter's name, byte size, and
location (frame-base offset or register), from .debug_info/.debug_abbrev
(DWARF 4 and common DWARF 5 forms).

Copied from the reference package (pixie_tpu/obj_tools/dwarf_reader.py).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Optional

# ---- DWARF constants (DWARF4/5 spec) ----
DW_TAG_formal_parameter = 0x05
DW_TAG_unspecified_parameters = 0x18
DW_TAG_compile_unit = 0x11
DW_TAG_base_type = 0x24
DW_TAG_pointer_type = 0x0F
DW_TAG_typedef = 0x16
DW_TAG_const_type = 0x26
DW_TAG_volatile_type = 0x35
DW_TAG_subprogram = 0x2E

DW_AT_location = 0x02
DW_AT_name = 0x03
DW_AT_byte_size = 0x0B
DW_AT_low_pc = 0x11
DW_AT_type = 0x49
DW_AT_specification = 0x47
DW_AT_abstract_origin = 0x31
DW_AT_linkage_name = 0x6E
DW_AT_str_offsets_base = 0x72
DW_AT_frame_base = 0x40

DW_OP_call_frame_cfa = 0x9C

DW_OP_fbreg = 0x91
DW_OP_regn = 0x50  # DW_OP_reg0..reg31 = 0x50..0x6f

# forms
F_ADDR, F_BLOCK2, F_BLOCK4, F_DATA2, F_DATA4, F_DATA8 = 1, 3, 4, 5, 6, 7
F_STRING, F_BLOCK, F_BLOCK1, F_DATA1, F_FLAG, F_SDATA = 8, 9, 0xA, 0xB, 0xC, 0xD
F_STRP, F_UDATA, F_REF_ADDR, F_REF1, F_REF2, F_REF4 = 0xE, 0xF, 0x10, 0x11, 0x12, 0x13
F_REF8, F_REF_UDATA, F_INDIRECT, F_SEC_OFFSET = 0x14, 0x15, 0x16, 0x17
F_EXPRLOC, F_FLAG_PRESENT, F_STRX, F_ADDRX = 0x18, 0x19, 0x1A, 0x1B
F_REF_SUP4, F_STRP_SUP, F_DATA16, F_LINE_STRP = 0x1C, 0x1D, 0x1E, 0x1F
F_REF_SIG8, F_IMPLICIT_CONST, F_LOCLISTX, F_RNGLISTX = 0x20, 0x21, 0x22, 0x23
F_STRX1, F_STRX2, F_STRX3, F_STRX4 = 0x25, 0x26, 0x27, 0x28
F_ADDRX1, F_ADDRX2, F_ADDRX3, F_ADDRX4 = 0x29, 0x2A, 0x2B, 0x2C


def _uleb(d: bytes, off: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = d[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _sleb(d: bytes, off: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = d[off]
        off += 1
        result |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            if b & 0x40:
                result -= 1 << shift
            return result, off


@dataclasses.dataclass
class ArgInfo:
    """One formal parameter of a function."""

    name: str
    byte_size: Optional[int]
    #: "fbreg<+/-N>" (frame-base relative, typical at -O0: the dwarvifier's
    #: stack-offset read) | "reg<N>" (in register) | None (no static location)
    location: Optional[str]
    type_name: str = ""


class DwarfReader:
    """Parse .debug_info for subprogram parameter names/sizes/locations."""

    def __init__(self, path: str):
        from pixie_tpu_torch.obj_tools.elf_reader import ElfReader

        elf = ElfReader(path)
        shstr = elf._strtab(elf.e_shstrndx)
        self._secs = {}
        for s in elf._sections:
            name = ElfReader._str_at(shstr, s["name"])
            self._secs[name] = elf.data[s["offset"]: s["offset"] + s["size"]]
        self.info = self._secs.get(".debug_info", b"")
        self.abbrev = self._secs.get(".debug_abbrev", b"")
        self.str = self._secs.get(".debug_str", b"")
        self.line_str = self._secs.get(".debug_line_str", b"")
        self.str_offsets = self._secs.get(".debug_str_offsets", b"")
        if not self.info:
            raise ValueError(f"{path}: no .debug_info (compile with -g)")
        #: DIE offset (info-section-relative) -> (tag, attrs dict)
        self.dies: dict[int, tuple[int, dict]] = {}
        #: function name -> subprogram DIE offset
        self.functions: dict[str, int] = {}
        #: subprogram DIE offsets that declare `...` varargs
        self._variadic_parents: set[int] = set()
        self._parse()

    # ------------------------------------------------------------- abbrevs
    def _abbrev_table(self, off: int) -> dict[int, tuple[int, bool, list]]:
        d = self.abbrev
        out = {}
        while off < len(d):
            code, off = _uleb(d, off)
            if code == 0:
                break
            tag, off = _uleb(d, off)
            children = d[off] != 0
            off += 1
            specs = []
            while True:
                attr, off = _uleb(d, off)
                form, off = _uleb(d, off)
                if attr == 0 and form == 0:
                    break
                if form == F_IMPLICIT_CONST:
                    const, off = _sleb(d, off)
                    specs.append((attr, form, const))
                else:
                    specs.append((attr, form, None))
            out[code] = (tag, children, specs)
        return out

    # ---------------------------------------------------------------- forms
    def _read_form(self, d, off, form, cu, const):
        e = "<"
        if form == F_ADDR:
            n = cu["addr_size"]
            return int.from_bytes(d[off: off + n], "little"), off + n
        if form in (F_DATA1, F_REF1, F_STRX1, F_ADDRX1, F_FLAG):
            return d[off], off + 1
        if form in (F_DATA2, F_REF2, F_STRX2, F_ADDRX2):
            return struct.unpack_from(e + "H", d, off)[0], off + 2
        if form in (F_STRX3, F_ADDRX3):
            return int.from_bytes(d[off: off + 3], "little"), off + 3
        if form in (F_DATA4, F_REF4, F_STRX4, F_ADDRX4, F_SEC_OFFSET,
                    F_REF_ADDR, F_STRP, F_LINE_STRP, F_REF_SUP4, F_STRP_SUP):
            return struct.unpack_from(e + "I", d, off)[0], off + 4
        if form in (F_DATA8, F_REF8, F_REF_SIG8):
            return struct.unpack_from(e + "Q", d, off)[0], off + 8
        if form == F_DATA16:
            return d[off: off + 16], off + 16
        if form in (F_UDATA, F_REF_UDATA, F_STRX, F_ADDRX, F_LOCLISTX,
                    F_RNGLISTX):
            return _uleb(d, off)
        if form == F_SDATA:
            return _sleb(d, off)
        if form == F_STRING:
            end = d.index(b"\x00", off)
            return d[off:end].decode("utf-8", "replace"), end + 1
        if form == F_EXPRLOC or form == F_BLOCK:
            n, off = _uleb(d, off)
            return bytes(d[off: off + n]), off + n
        if form == F_BLOCK1:
            n = d[off]
            return bytes(d[off + 1: off + 1 + n]), off + 1 + n
        if form == F_BLOCK2:
            n = struct.unpack_from(e + "H", d, off)[0]
            return bytes(d[off + 2: off + 2 + n]), off + 2 + n
        if form == F_BLOCK4:
            n = struct.unpack_from(e + "I", d, off)[0]
            return bytes(d[off + 4: off + 4 + n]), off + 4 + n
        if form == F_FLAG_PRESENT:
            return True, off
        if form == F_IMPLICIT_CONST:
            return const, off
        if form == F_INDIRECT:
            real, off = _uleb(d, off)
            return self._read_form(d, off, real, cu, None)
        raise ValueError(f"unsupported DWARF form 0x{form:x}")

    @staticmethod
    def _cstr(tab: bytes, off: int) -> str:
        end = tab.find(b"\x00", off)
        return tab[off:end].decode("utf-8", "replace") if end >= 0 else ""

    def _strx(self, cu, idx: int) -> str:
        base = cu.get("str_off_base")
        if base is None or not self.str_offsets:
            return ""
        pos = base + 4 * idx
        if pos + 4 > len(self.str_offsets):
            return ""
        off = struct.unpack_from("<I", self.str_offsets, pos)[0]
        return self._cstr(self.str, off)

    def _attr_str(self, cu, form, val) -> str:
        if form == F_STRING:
            return val
        if form == F_STRP:
            return self._cstr(self.str, val)
        if form == F_LINE_STRP:
            return self._cstr(self.line_str, val)
        if form in (F_STRX, F_STRX1, F_STRX2, F_STRX3, F_STRX4):
            return self._strx(cu, val)
        return ""

    # ---------------------------------------------------------------- parse
    def _parse(self) -> None:
        d = self.info
        pos = 0
        while pos + 11 <= len(d):
            cu_start = pos
            (unit_len,) = struct.unpack_from("<I", d, pos)
            if unit_len == 0 or unit_len == 0xFFFFFFFF:
                break  # 64-bit DWARF unsupported; stop cleanly
            next_cu = pos + 4 + unit_len
            (version,) = struct.unpack_from("<H", d, pos + 4)
            if version >= 5:
                unit_type = d[pos + 6]
                addr_size = d[pos + 7]
                (abbrev_off,) = struct.unpack_from("<I", d, pos + 8)
                pos += 12
                if unit_type not in (0x01, 0x03):  # compile/partial unit
                    pos = next_cu
                    continue
            else:
                (abbrev_off,) = struct.unpack_from("<I", d, pos + 6)
                addr_size = d[pos + 10]
                pos += 11
            cu = {"start": cu_start, "addr_size": addr_size,
                  "str_off_base": 8 if self.str_offsets else None}
            table = self._abbrev_table(abbrev_off)
            stack = []
            while pos < next_cu:
                die_off = pos
                code, pos = _uleb(d, pos)
                if code == 0:
                    if stack:
                        stack.pop()
                    continue
                entry = table.get(code)
                if entry is None:
                    pos = next_cu
                    break
                tag, children, specs = entry
                attrs = {}
                for attr, form, const in specs:
                    val, pos = self._read_form(d, pos, form, cu, const)
                    s = self._attr_str(cu, form, val)
                    if s:
                        val = s
                    if form in (F_REF1, F_REF2, F_REF4, F_REF8, F_REF_UDATA):
                        val = cu_start + val  # CU-relative → section offset
                    attrs[attr] = val
                self.dies[die_off] = (tag, attrs)
                if tag == DW_TAG_compile_unit:
                    # per-CU str_offsets base for strx resolution (the root
                    # DIE's own strx attrs resolved with the header default,
                    # which only affects CU-name strings we don't consume)
                    base = attrs.get(DW_AT_str_offsets_base)
                    if isinstance(base, int):
                        cu["str_off_base"] = base
                if tag == DW_TAG_subprogram:
                    name = attrs.get(DW_AT_name) or attrs.get(
                        DW_AT_linkage_name)
                    if isinstance(name, str) and name:
                        self.functions.setdefault(name, die_off)
                if children:
                    stack.append(die_off)
                # record parentage for parameter attachment (and varargs
                # markers: DW_TAG_unspecified_parameters flags variadics)
                if stack and tag in (DW_TAG_formal_parameter,
                                     DW_TAG_unspecified_parameters):
                    attrs["__parent"] = stack[-1]
                    if tag == DW_TAG_unspecified_parameters:
                        self._variadic_parents.add(stack[-1])
            pos = next_cu

    # ----------------------------------------------------------------- query
    def _type_info(self, ref, depth=0) -> tuple[Optional[int], str]:
        if ref is None or depth > 16 or ref not in self.dies:
            return None, ""
        tag, attrs = self.dies[ref]
        name = attrs.get(DW_AT_name, "")
        if tag == DW_TAG_pointer_type:
            return 8, (self._type_info(attrs.get(DW_AT_type),
                                       depth + 1)[1] + "*")
        if tag in (DW_TAG_typedef, DW_TAG_const_type, DW_TAG_volatile_type):
            size, inner = self._type_info(attrs.get(DW_AT_type), depth + 1)
            return size, name if isinstance(name, str) and name else inner
        size = attrs.get(DW_AT_byte_size)
        return (int(size) if size is not None else None,
                name if isinstance(name, str) else "")

    @staticmethod
    def _decode_location(expr) -> Optional[str]:
        if not isinstance(expr, (bytes, bytearray)) or not expr:
            return None
        op = expr[0]
        if op == DW_OP_fbreg:
            off, _ = _sleb(expr, 1)
            return f"fbreg{off:+d}"
        if DW_OP_regn <= op <= DW_OP_regn + 31:
            return f"reg{op - DW_OP_regn}"
        return None

    def function_args(self, fn_name: str) -> list[ArgInfo]:
        """Formal parameters of `fn_name`, in declaration order."""
        die_off = self.functions.get(fn_name)
        if die_off is None:
            raise KeyError(f"no DWARF subprogram named {fn_name!r}")
        out = []
        for off in sorted(self.dies):
            tag, attrs = self.dies[off]
            if tag != DW_TAG_formal_parameter:
                continue
            if attrs.get("__parent") != die_off:
                continue
            size, tname = self._type_info(attrs.get(DW_AT_type))
            name = attrs.get(DW_AT_name, "")
            out.append(ArgInfo(
                name=name if isinstance(name, str) else "",
                byte_size=size,
                location=self._decode_location(attrs.get(DW_AT_location)),
                type_name=tname,
            ))
        return out

    def function_is_variadic(self, fn_name: str) -> bool:
        """True when the subprogram declares `...` varargs
        (DW_TAG_unspecified_parameters child) — O(1), recorded at parse."""
        die_off = self.functions.get(fn_name)
        if die_off is None:
            raise KeyError(f"no DWARF subprogram named {fn_name!r}")
        return die_off in self._variadic_parents

    def function_frame_base(self, fn_name: str):
        """'cfa' | 'reg<N>' | None — how fbreg offsets are anchored
        (DW_AT_frame_base).  gcc emits DW_OP_call_frame_cfa; clang -O0
        anchors on RBP (reg6), which shifts every fbreg offset — codegen
        must not assume CFA blindly."""
        die_off = self.functions.get(fn_name)
        if die_off is None:
            raise KeyError(f"no DWARF subprogram named {fn_name!r}")
        _tag, attrs = self.dies[die_off]
        expr = attrs.get(DW_AT_frame_base)
        if not isinstance(expr, (bytes, bytearray)) or not expr:
            return None
        if expr[0] == DW_OP_call_frame_cfa:
            return "cfa"
        if DW_OP_regn <= expr[0] <= DW_OP_regn + 31:
            return f"reg{expr[0] - DW_OP_regn}"
        return None

    def function_names(self) -> list[str]:
        return sorted(self.functions)
