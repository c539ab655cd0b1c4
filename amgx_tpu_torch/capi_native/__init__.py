"""The port's native C API: ``amgx_c_shim.cpp`` (``libamgx_torch_c.so``,
embedding CPython over :mod:`amgx_tpu_torch.capi`), its extension header
and the C drivers, built without cmake by :mod:`.build`."""
