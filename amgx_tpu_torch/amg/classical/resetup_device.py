"""Device-numeric classical resetup: the values-only Galerkin refresh
(port of ``amgx_tpu/amg/classical/resetup_device.py``; reference
``csr_multiply.h:100-126``, whose numeric phase reuses the symbolic
structure).

Symbolic once at setup, numeric at each resetup, both on the level's
device:

* at setup (only when ``structure_reuse_levels`` ≠ 0) each classical
  level records a :class:`LevelPlan`: the frozen P values, the A·P and
  R·(AP) triple schedules of ``out[t_out] += a[t_a]·b[t_b]``, the coarse
  CSR pattern, and maps from coarse CSR value order into every value
  array of the level's device pack — found with an index-probe pack
  (the pattern packed through the port's own ``pack_host_arrays``, each
  entry's value its index + 1, in f64 on the CPU);
* at resetup the refreshed fine values flow down the hierarchy as two
  ordered segment sums a level and a fill of each pack array; only the
  small coarsest operator comes to the host (its dense factorisation).

No atomic scatter: ``jax.ops.segment_sum`` becomes, per schedule, the
triples sorted by output slot once (stable, so each slot adds its terms
in schedule order) and an accumulation rank by rank — the k-th term of
every slot that has one is added in one elementwise step — so every sum
runs in one order on every device (``index_add_`` on a CUDA tensor
orders its adds differently from run to run).  The schedules are the
device setup engine's :class:`~...ops.spgemm.GalerkinPlan` of the level:
a plan the engine cached while it built the level serves here without a
second symbolic pass.

A pack layout that depends on the values (the shift pack's classes and
slice mask, B3's ``row_len``, the compact packs of B2, B4 and B5) has to
come out of the probe exactly as the level's own pack holds it; any
difference makes :func:`build_level_plan` return None, which sends the
resetup down the host replay.  P stays frozen across values-only
resetups, as in the host replay.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ...core.matrix import (DIA_MAX_DIAGS, DeviceMatrix, Matrix,
                            assemble_device_matrix, dia_arrays,
                            dia_device_matrix, pack_host_arrays)
from ...ops.spgemm import (GalerkinPlan, Schedule, build_galerkin_plan,
                           run_schedule)

#: the probe packs entry indices + 1 as f64 values, exact below 2^53
#: (the JAX package probes in the pack dtype, f32, and stops at 2^24)
_PROBE_EXACT = 1 << 53
#: the value arrays of a pack a refresh fills, with their compact packs
_VALUE_FIELDS = ("vals", "diag", "sh_vals", "bn_vals")
_COMPACT_FIELDS = ("sh_compact", "bn_compact")


def _index(a: np.ndarray, dev) -> torch.Tensor:
    """int32 where the index space allows."""
    dt = np.int32 if a.size == 0 or a.max(initial=0) < 2 ** 31 else np.int64
    return torch.from_numpy(np.ascontiguousarray(a.astype(dt))).to(dev)


def _probe_pack(Ac: sp.csr_matrix) -> DeviceMatrix:
    """The pack ``Matrix(Ac).device()`` builds, on the CPU in f64, with
    every stored entry's value its index + 1."""
    probe = sp.csr_matrix((np.arange(1, Ac.nnz + 1, dtype=np.float64),
                           Ac.indices, Ac.indptr), shape=Ac.shape)
    if probe.shape[0] == probe.shape[1]:
        dia = dia_arrays(probe, max_diags=DIA_MAX_DIAGS)
        if dia is not None and len(dia[0]):
            return dia_device_matrix(dia[0], torch.from_numpy(dia[1]),
                                     None, probe.shape[1])
    arrays, meta = pack_host_arrays(probe, 1, np.float64, dia_max_diags=0)
    return assemble_device_matrix(arrays, meta, "cpu")


def _fields(pack) -> Dict[str, object]:
    """Every field of a pack by name, its compact packs' fields as
    ``"sh_compact.vals"`` and so on."""
    out = {}
    for f in dataclasses.fields(pack):
        v = getattr(pack, f.name)
        if f.name in _COMPACT_FIELDS and v is not None:
            for g in dataclasses.fields(v):
                out[f"{f.name}.{g.name}"] = getattr(v, g.name)
        else:
            out[f.name] = v
    return out


def _is_value(name: str, fmt: str) -> bool:
    if fmt == "dia":
        # a DIA pack's diag is a view of its vals
        return name == "vals"
    return name in _VALUE_FIELDS or name.endswith("_compact.vals")


def _value_maps(Ac: sp.csr_matrix,
                template) -> Optional[Dict[str, np.ndarray]]:
    """Maps from coarse CSR value order into every value array of the
    level's pack (-1: a padding slot, which stays 0), or None when the
    probe pack differs from ``template`` in anything but its values."""
    probe = _probe_pack(Ac)
    got, want = _fields(probe), _fields(template)
    if got.keys() != want.keys():
        return None
    maps = {}
    for name, p in got.items():
        t = want[name]
        if (p is None) != (t is None):
            return None
        if isinstance(p, torch.Tensor):
            if tuple(p.shape) != tuple(t.shape):
                return None
            if _is_value(name, probe.fmt):
                maps[name] = np.rint(p.numpy()).astype(np.int64) - 1
            elif name != "diag" and not torch.equal(p, t.cpu()):
                # a value-dependent layout that merely has the same
                # shape would put refreshed values into wrong slots
                return None
        elif p != t:
            return None
    return maps


@dataclasses.dataclass
class LevelPlan:
    """One classical level's device-refresh schedule (host arrays; the
    device copies upload at the first refresh)."""
    P_data: np.ndarray            # frozen P values (CSR order)
    perm_RP: np.ndarray           # R.data = P.data[perm_RP]
    ap: Schedule                  # A·P
    ac: Schedule                  # R·(AP)
    Ac_indptr: np.ndarray
    Ac_indices: np.ndarray
    Ac_shape: tuple
    pack_maps: dict
    #: the level's own pack: its structure arrays are reused as they
    #: are, only the value arrays are replaced at refresh
    template: object = None
    _dev: Optional[dict] = None

    def device_arrays(self, device) -> dict:
        if self._dev is None or self._dev["P"].device != device:
            d = {"P": torch.from_numpy(self.P_data).to(device),
                 "perm": _index(self.perm_RP, device),
                 "ap": self.ap.device_arrays(device),
                 "ac": self.ac.device_arrays(device)}
            for name, m in self.pack_maps.items():
                d["map_" + name] = _index(m.reshape(-1) + 1, device)
            self._dev = d
        return self._dev


def build_level_plan(A_csr: sp.csr_matrix, P_csr: sp.csr_matrix,
                     Ac_csr: sp.csr_matrix, template,
                     plan: Optional[GalerkinPlan] = None
                     ) -> Optional[LevelPlan]:
    """The refresh schedules of one level: those of ``plan`` (the
    engine's cached Galerkin plan of this A and P pattern), else a
    symbolic pass of its own on the device of ``template`` (the level's
    pack).  None past the probe's exactness,
    when the schedule's coarse pattern is not the one the setup packed,
    or when the probe pack differs from ``template``."""
    A = sp.csr_matrix(A_csr)
    A.sort_indices()
    P = sp.csr_matrix(P_csr)
    P.sort_indices()
    if template is None or max(A.nnz, P.nnz, Ac_csr.nnz) >= _PROBE_EXACT:
        return None
    if plan is None:
        plan = build_galerkin_plan(A, P, device=template.device)
    Acs = sp.csr_matrix(Ac_csr)
    Acs.sort_indices()
    if not (np.array_equal(plan.Ac_indptr, Acs.indptr.astype(np.int64))
            and np.array_equal(plan.Ac_indices,
                               Acs.indices.astype(np.int32))):
        return None
    maps = _value_maps(Acs, template)
    if maps is None:
        return None
    return LevelPlan(
        P_data=np.asarray(P.data), perm_RP=plan.perm_RP,
        ap=plan.ap, ac=plan.ac,
        Ac_indptr=Acs.indptr.copy(), Ac_indices=Acs.indices.copy(),
        Ac_shape=Acs.shape, pack_maps=maps, template=template)


def fine_dia_to_csr_map(A_csr: sp.csr_matrix, offs) -> np.ndarray:
    """``csr_data[j] = dia_vals.reshape(-1)[map[j]]`` for a row-aligned
    DIA pack with diagonal offsets ``offs``."""
    A = sp.csr_matrix(A_csr)
    A.sort_indices()
    n = A.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    d = A.indices.astype(np.int64) - rows
    offs = np.asarray([int(o) for o in offs], dtype=np.int64)
    k = np.minimum(np.searchsorted(offs, d), len(offs) - 1)
    if not np.all(offs[k] == d):
        raise ValueError("CSR entry outside the DIA offset set")
    return (k * n + rows).astype(np.int64)


def refresh_level(plan: LevelPlan, vA: torch.Tensor):
    """The values-only refresh of one level on ``vA``'s device, in its
    dtype: ``(vAc (nnz_Ac,), {pack field: refreshed array})``."""
    d = plan.device_arrays(vA.device)
    P = d["P"].to(vA.dtype)
    vAP = run_schedule(plan.ap, d["ap"], vA, P)
    vAc = run_schedule(plan.ac, d["ac"], P[d["perm"]], vAP)
    ext = torch.cat([vAc.new_zeros(1), vAc])
    fields = {name: ext[d["map_" + name]].reshape(m.shape)
              for name, m in plan.pack_maps.items()}
    return vAc, fields


def assemble_refreshed_matrix(plan: LevelPlan, vAc: torch.Tensor,
                              fields) -> Matrix:
    """The refreshed level as a :class:`Matrix`: the level's pack with
    its value arrays replaced (its structure arrays are the same
    tensors); the host CSR downloads at first use."""
    tmpl = plan.template
    if tmpl.fmt == "dia":
        pack = dia_device_matrix(tmpl.dia_offsets, fields["vals"], None,
                                 tmpl.n_cols)
    else:
        repl = {name: fields[name] for name in _VALUE_FIELDS
                if name in fields}
        for cname in _COMPACT_FIELDS:
            if cname + ".vals" in fields:
                repl[cname] = dataclasses.replace(
                    getattr(tmpl, cname), vals=fields[cname + ".vals"])
        pack = dataclasses.replace(tmpl, **repl)
    m = Matrix.from_device_pack(pack, nnz_hint=len(plan.Ac_indices))
    m._csr_pattern = (plan.Ac_indptr, plan.Ac_indices, plan.Ac_shape)
    m._csr_vals_dev = vAc
    return m
