"""The native host runtime: ``native`` (vertex welding, the OBJ writer and
reader in C++, built with g++ at first use)."""

from bsdmg_tpu_torch.runtime.native import (
    native_available,
    weld_vertices_native,
    write_obj_native,
)

__all__ = ["native_available", "weld_vertices_native", "write_obj_native"]
