"""Device setup engine (port of ``amgx_tpu/amg/device_setup/``;
reference ``CSR_Multiply::csr_galerkin_product``, whose symbolic phase
sizes the output once and whose numeric phase re-runs on new values).

A process-wide, pattern-keyed cache of Galerkin plans for the host
classical and aggregation setup paths: the symbolic pass runs once per
(A pattern, P pattern or aggregates, dtype), and the numeric pass runs
on the level's device as ordered segment sums, so a resetup on new
coefficients is a numeric pass only.

Declines: a level below ``device_setup_min_rows``, an empty operand, a
plan past the byte budget or a dtype other than f32/f64 returns None to
the caller, which runs the host product; each is counted in
:meth:`DeviceSetupEngine.stats` with its reason.  An error inside a
numeric pass is not a decline: it raises.
"""
from .engine import (DeviceSetupEngine, engine, engine_stats,
                     reset_engine)

__all__ = ["DeviceSetupEngine", "engine", "engine_stats",
           "reset_engine"]
