"""Object-file tooling: ELF reading + address symbolization.

Reference: src/stirling/obj_tools/ (elf_reader.cc symbol iteration +
address→symbol lookup; used by the perf profiler's symbolizers and dynamic
tracing's target resolution).

Copied from the reference package (pixie_tpu/obj_tools/__init__.py).
"""
from pixie_tpu_torch.obj_tools.elf_reader import (
    ElfReader,
    ElfSymbol,
    NativeSymbolizer,
)

__all__ = ["ElfReader", "ElfSymbol", "NativeSymbolizer"]
