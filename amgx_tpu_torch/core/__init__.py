from .matrix import DeviceMatrix, Matrix, dia_arrays, pack_device, pack_kind

__all__ = ["DeviceMatrix", "Matrix", "dia_arrays", "pack_device",
           "pack_kind"]
