from .matrix import DeviceMatrix, Matrix, dia_arrays

__all__ = ["DeviceMatrix", "Matrix", "dia_arrays"]
