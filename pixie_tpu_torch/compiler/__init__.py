"""The PxL compiler, copied from the reference package (pixie_tpu/compiler/):
PxL text → a logical Plan (compile_pxl; several vis funcs fused into one
with compile_pxl_funcs)."""
from pixie_tpu_torch.compiler.compiler import CompiledQuery, compile_pxl, compile_pxl_funcs
from pixie_tpu_torch.compiler.pxl import CompileCtx, DataFrame, GroupedDataFrame, Scalar
from pixie_tpu_torch.compiler.pxmodule import PxModule

__all__ = [
    "CompiledQuery",
    "compile_pxl",
    "compile_pxl_funcs",
    "CompileCtx",
    "DataFrame",
    "GroupedDataFrame",
    "Scalar",
    "PxModule",
]
