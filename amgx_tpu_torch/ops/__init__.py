"""Operators: BLAS-1 (``blas``), the DIA, ELL and binned SpMV kernels
and their plain versions (``dia_spmv``, ``ell_spmv``, ``binned_spmv``),
the SpMV dispatch (``spmv``), the device SpGEMM primitives of the
classical setup (``spgemm``) and the device ELL pack builder
(``device_pack``)."""
