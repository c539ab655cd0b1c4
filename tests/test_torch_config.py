"""The port's config system parses every config string of the benchmark
and the iteration-trend test to the same scoped values as amgx_tpu's."""
import ast
import importlib.util
from pathlib import Path

import pytest

import amgx_tpu
import amgx_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def _bench_configs():
    tree = ast.parse((ROOT / "bench.py").read_text())
    return sorted({n.value for n in ast.walk(tree)
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)
                   and n.value.startswith("config_version=")})


def _trend_configs():
    spec = importlib.util.spec_from_file_location(
        "_iter_trend_cfgs", ROOT / "tests" / "test_iter_trend.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [mod.CFG_AGG, mod.CFG_CLA]


CONFIGS = _bench_configs() + _trend_configs()


def test_config_sources_found():
    # the headline FGMRES stack, the classical stacks and the trend pair
    assert len(CONFIGS) >= 8
    assert any("solver(out)=FGMRES" in c and "selector=GEO" in c
               for c in CONFIGS)


@pytest.mark.parametrize("text", CONFIGS,
                         ids=[f"cfg{i}" for i in range(len(CONFIGS))])
def test_config_parses_like_jax(text):
    ref = amgx_tpu.AMGConfig(text)
    got = amgx_tpu_torch.AMGConfig(text)
    assert list(got.items()) == list(ref.items())
    assert got.config_version == ref.config_version
    # scoped lookups (with registry defaults) agree too
    for scope, name, _, _ in ref.items():
        for probe in (name, "max_iters", "tolerance", "smoother",
                      "relaxation_factor"):
            assert got.get(probe, scope) == ref.get(probe, scope)
