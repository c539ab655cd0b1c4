"""Operators: BLAS-1 (``blas``), the DIA SpMV kernel and its plain
version (``dia_spmv``) and the SpMV dispatch (``spmv``)."""
