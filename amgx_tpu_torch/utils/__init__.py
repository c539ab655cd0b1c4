"""Utilities (port of the parts of ``amgx_tpu/utils`` the port needs)."""
