"""The port's native host library: the CPU route's fast paths (native/build.py)."""
from pixie_tpu_torch.native.build import build_error, load_native

__all__ = ["build_error", "load_native"]
