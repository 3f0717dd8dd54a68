"""The PxL compiler, copied from the reference package (pixie_tpu/compiler/):
PxL text → a logical Plan (compile_pxl)."""
from pixie_tpu_torch.compiler.compiler import CompiledQuery, compile_pxl
from pixie_tpu_torch.compiler.pxl import CompileCtx, DataFrame, GroupedDataFrame, Scalar
from pixie_tpu_torch.compiler.pxmodule import PxModule

__all__ = [
    "CompiledQuery",
    "compile_pxl",
    "CompileCtx",
    "DataFrame",
    "GroupedDataFrame",
    "Scalar",
    "PxModule",
]
