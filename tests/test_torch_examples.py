"""The port's example drivers (``examples_torch/``) run end to end in
subprocesses with ``-mode hDDI`` (the CPU; their default, dDDI, is the
card), each the counterpart of a driver of ``examples/`` run by
tests/test_examples.py.  The default tier keeps one driver per flow
family, the rest are the nightly tier (``pytest -m slow``)."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from amgx_tpu_torch.io import poisson7pt, write_matrix_market

REPO = str(pathlib.Path(__file__).resolve().parents[1])

#: (script, args, fast?) — tests/test_examples.py's list, plus
#: amgx_mpi_poisson7.py (a config file, the generated distributed Poisson)
EXAMPLES = [
    ("amgx_capi.py", ["-m", "{mtx}", "-c", "{cfg}"], True),
    ("amgx_mpi_capi.py", ["-m", "{mtx}", "-p", "4"], False),
    ("amgx_mpi_capi_agg.py", ["-m", "{mtx}", "-p", "4"], True),
    ("amgx_mpi_capi_cla.py", ["-m", "{mtx}", "-p", "4"], False),
    ("eigensolver.py", ["-m", "{mtx}"], False),
    ("amgx_spmv_test.py", ["-m", "{mtx}", "-r", "3"], False),
    ("convert.py", ["{mtx}", "{out}"], True),
    ("amgx_capi_multi.py", ["-m", "{mtx}", "-t", "2"], False),
    ("amgx_mpi_capi_multi.py", ["-m", "{mtx}", "-p", "7"], True),
    ("amgx_mpi_poisson5pt.py", ["-p", "24", "24", "2", "2"], False),
    ("eigensolver_mpi.py", ["-m", "{mtx}", "-p", "4"], False),
    ("amgx_resetup_timestepping.py", ["-n", "12", "-steps", "2"], True),
    ("amgx_mpi_poisson7.py", ["-c", "{cfg}", "-p", "4", "4", "4", "2", "2",
                              "2"], False),
]


@pytest.fixture(scope="module")
def system_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples_torch")
    A = poisson7pt(8, 8, 8)
    path = str(d / "p8.mtx")
    write_matrix_market(path, A, rhs=np.ones(A.shape[0]))
    cfg = str(d / "cfg.json")
    with open(cfg, "w") as f:
        f.write('{"config_version": 2, "solver": {"solver": "PCG", '
                '"max_iters": 200, "monitor_residual": 1, '
                '"tolerance": 1e-8, "convergence": "RELATIVE_INI"}}')
    return {"mtx": path, "cfg": cfg, "out": str(d / "out.bin")}


def test_every_example_has_a_counterpart():
    ours = {p.name for p in (pathlib.Path(REPO) / "examples_torch")
            .glob("*.py")}
    theirs = {p.name for p in (pathlib.Path(REPO) / "examples")
              .glob("*.py")}
    assert ours == theirs and {e[0] for e in EXAMPLES} == theirs


@pytest.mark.parametrize(
    "script,args",
    [pytest.param(e[0], e[1], id=e[0],
                  marks=() if e[2] else (pytest.mark.slow,))
     for e in EXAMPLES])
def test_example_runs(script, args, system_file):
    argv = [a.format(**system_file) for a in args] + ["-mode", "hDDI"]
    r = subprocess.run([sys.executable, f"examples_torch/{script}", *argv],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, (script, r.stdout[-800:], r.stderr[-800:])
    if script == "convert.py":
        from amgx_tpu_torch.io import read_system_auto
        back = read_system_auto(system_file["out"])
        assert (back.A != poisson7pt(8, 8, 8)).nnz == 0
        np.testing.assert_array_equal(back.rhs, np.ones(512))
    else:
        done = ("status=0", "timestepping done", "eigenvalues", "GFLOPS")
        assert any(w in r.stdout for w in done), r.stdout[-800:]
