"""Configuration system (a copy of ``amgx_tpu/config/__init__.py``,
which is framework-free; reference ``base/include/amg_config.h``,
``base/src/amg_config.cu``): a typed, scoped parameter store populated
from ``key=value`` strings (config_version 1/2), legacy ``.cfg`` files,
or JSON documents (``config_version: 2`` with nested solver objects and
``scope`` keys, e.g. ``core/configs/FGMRES_AGGREGATION.json``).

Scope semantics (mirroring ``amg_config.cu:563-631`` ``import_json_object``):
a nested JSON object under key K defines a child solver; the parent scope
records parameter K = the object's ``"solver"`` value, annotated with the
object's ``"scope"`` name; all other entries in the object are stored under
the child scope.  Lookup `get(name, scope)` checks (scope, name) then
("default", name) then the registry default.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, Optional, Tuple

from ..errors import BadConfigurationError
from . import registry
from .registry import (ParameterDescription, all_parameters, coerce,
                       get_description, register_parameter)

__all__ = [
    "AMGConfig", "register_parameter", "get_description", "all_parameters",
    "ParameterDescription",
]

_IDENT_RE = re.compile(r"^[A-Za-z0-9_.\- ]+$")
_unnamed_scope_counter = [0]


class AMGConfig:
    """A scoped parameter store (reference: ``AMG_Config``)."""

    #: parameters only allowed in the default scope (amg_config.cu:544-548)
    _DEFAULT_SCOPE_ONLY = frozenset({
        "determinism_flag", "block_format", "separation_interior",
        "separation_exterior", "min_rows_latency_hiding",
        "fine_level_consolidation", "use_cuda_ipc_consolidation",
    })

    #: parameters that may carry a new_scope annotation (solver-valued)
    _SOLVER_PARAMS = frozenset({
        "solver", "preconditioner", "smoother", "coarse_solver",
        "fine_smoother", "coarse_smoother", "eig_solver",
        "eig_eigenvector_solver",
    })

    def __init__(self, source: "str | dict | None" = None):
        # (scope, name) -> (value, new_scope)
        self._params: Dict[Tuple[str, str], Tuple[Any, str]] = {}
        self._scopes = {"default"}
        self.config_version = 2
        self.allow_modifications = True
        if source is not None:
            self.parse(source)

    # ------------------------------------------------------------------ parse
    def parse(self, source: "str | dict") -> "AMGConfig":
        """Parse a JSON dict, JSON text, key=value string, or file path."""
        if isinstance(source, dict):
            self._import_json_object(source, outer=True)
            return self
        text = source.strip()
        if text.startswith("{"):
            return self.parse_json_string(text)
        return self.parse_string(text)

    @classmethod
    def from_file(cls, path: str) -> "AMGConfig":
        cfg = cls()
        cfg.parse_file(path)
        return cfg

    def parse_file(self, path: str) -> "AMGConfig":
        with open(path) as f:
            text = f.read()
        try:
            doc = json.loads(text)
        except ValueError:
            return self.parse_string(text)
        self._import_json_object(doc, outer=True)
        return self

    def parse_json_string(self, text: str) -> "AMGConfig":
        try:
            doc = json.loads(text)
        except ValueError as e:
            raise BadConfigurationError(f"cannot parse JSON config: {e}")
        self._import_json_object(doc, outer=True)
        return self

    def parse_string(self, params: str) -> "AMGConfig":
        """Parse ``key=value`` entries separated by ``,``, ``;`` or newlines.

        Grammar per entry (``amg_config.cu:1247-1330`` extractParamInfo):
        ``[current_scope:]name[(new_scope)]=value``.
        """
        entries = re.split(r"[,;\n]+", params)
        parsed = []
        for entry in entries:
            entry = entry.strip()
            if not entry:
                continue
            parsed.append(self._extract_param_info(entry))
        # config_version handling (amg_config.cu:172-208)
        version = 1
        if parsed and parsed[0][0] == "config_version":
            version = int(float(parsed[0][1]))
            if version not in (1, 2):
                raise BadConfigurationError(
                    f"config_version must be 1 or 2, got {version}")
            parsed = parsed[1:]
        self.config_version = version
        for name, value, cur_scope, new_scope in parsed:
            if version == 1:
                if cur_scope != "default" or new_scope != "default":
                    raise BadConfigurationError(
                        "scopes require config_version=2: "
                        f"{cur_scope}:{name}({new_scope})")
                # v1 -> v2 conversion (amg_config.cu:210-266)
                if name == "smoother_weight":
                    name = "relaxation_factor"
                elif name == "min_block_rows":
                    name = "min_coarse_rows"
                if value in ("JACOBI", "JACOBI_NO_CUSP"):
                    value = "BLOCK_JACOBI"
            self._set_entry(name, value, cur_scope, new_scope)
        return self

    @staticmethod
    def _extract_param_info(entry: str) -> Tuple[str, str, str, str]:
        if entry.count("=") != 1:
            raise BadConfigurationError(
                f"config entry must contain exactly one '=': {entry!r}")
        name, value = entry.split("=")
        value = value.strip()
        name = name.strip()
        new_scope = "default"
        m = re.match(r"^([^()]*)\(([^()]*)\)$", name)
        if m:
            name, new_scope = m.group(1).strip(), m.group(2).strip()
            if new_scope == "default" or not new_scope:
                raise BadConfigurationError(
                    f"new scope cannot be empty/default: {entry!r}")
        elif "(" in name or ")" in name:
            raise BadConfigurationError(f"unbalanced parentheses: {entry!r}")
        cur_scope = "default"
        if ":" in name:
            if name.count(":") > 1:
                raise BadConfigurationError(f"too many ':' in {entry!r}")
            cur_scope, name = (s.strip() for s in name.split(":"))
        for s in (name, cur_scope, new_scope):
            if not s or not _IDENT_RE.match(s):
                raise BadConfigurationError(f"bad identifier in {entry!r}")
        return name, value, cur_scope, new_scope

    def _import_json_object(self, obj: dict, outer: bool,
                            current_scope: str = "default"):
        current_scope = obj.get("scope", current_scope if not outer
                                else "default")
        for key, val in obj.items():
            if key in ("config_version", "scope"):
                if key == "config_version":
                    self.config_version = int(val)
                continue
            if key in ("solver", "eig_solver") and not outer:
                continue  # handled by the parent (importNamedParameter)
            if isinstance(val, dict):
                child = dict(val)
                if "scope" not in child:
                    child["scope"] = (
                        f"unnamed_solver_{_unnamed_scope_counter[0]}")
                    _unnamed_scope_counter[0] += 1
                solver_key = "eig_solver" if "eig_solver" in child else "solver"
                if solver_key not in child:
                    raise BadConfigurationError(
                        f"nested solver object {key!r} has no 'solver' entry")
                self._set_entry(key, child[solver_key], current_scope,
                                child["scope"])
                self._import_json_object(child, outer=False,
                                         current_scope=child["scope"])
            elif isinstance(val, (int, float, str)):
                self._set_entry(key, val, current_scope, "default")
            elif isinstance(val, bool):
                self._set_entry(key, int(val), current_scope, "default")
            elif isinstance(val, list):
                self._set_entry(key, val, current_scope, "default")
            else:
                raise BadConfigurationError(
                    f"cannot import parameter {key!r} of type "
                    f"{type(val).__name__}")

    # -------------------------------------------------------------- get / set
    def _set_entry(self, name: str, value: Any, current_scope: str,
                   new_scope: str):
        if new_scope != "default":
            if new_scope in self._scopes and not self.allow_modifications:
                raise BadConfigurationError(
                    f"new scope already defined: {new_scope}")
            if name not in self._SOLVER_PARAMS:
                raise BadConfigurationError(
                    "a new scope can only be associated with a solver: "
                    f"{name}({new_scope})")
            self._scopes.add(new_scope)
        if name in self._DEFAULT_SCOPE_ONLY and current_scope != "default":
            raise BadConfigurationError(
                f"parameter {name!r} can only be set in the default scope")
        value = coerce(name, value)
        self._params[(current_scope, name)] = (value, new_scope)

    def set(self, name: str, value: Any, scope: str = "default",
            new_scope: str = "default"):
        self._set_entry(name, value, scope, new_scope)

    def get(self, name: str, scope: str = "default", default: Any = None):
        """Scoped lookup: (scope, name) → ("default", name) → registry default."""
        for key in ((scope, name), ("default", name)):
            if key in self._params:
                return self._params[key][0]
        desc = get_description(name)
        if desc is not None:
            return desc.default
        if default is not None:
            return default
        raise BadConfigurationError(
            f"unknown parameter {name!r} (scope {scope!r})")

    def get_scoped(self, name: str, scope: str = "default") -> Tuple[Any, str]:
        """Return (value, new_scope) — used to allocate nested solvers.

        Reference: ``getParameter(name, &new_scope, current_scope)``.
        """
        for key in ((scope, name), ("default", name)):
            if key in self._params:
                return self._params[key]
        desc = get_description(name)
        if desc is not None:
            return desc.default, "default"
        raise BadConfigurationError(
            f"unknown parameter {name!r} (scope {scope!r})")

    def has(self, name: str, scope: str = "default") -> bool:
        return (scope, name) in self._params or ("default", name) in self._params

    def items(self):
        for (scope, name), (value, new_scope) in sorted(self._params.items()):
            yield scope, name, value, new_scope

    def stable_hash(self) -> str:
        """Stable digest of every (scope, name) → value entry — two
        configs that resolve identically hash equal regardless of the
        source text's entry order.  Keys serving sessions
        (serve/session.py) and the AOT executable store
        (serve/aot.py)."""
        import hashlib
        items = sorted((scope, name, str(v), str(ns))
                       for (scope, name), (v, ns) in self._params.items())
        return hashlib.blake2b(repr(items).encode(),
                               digest_size=12).hexdigest()

    def clone(self) -> "AMGConfig":
        cfg = AMGConfig()
        cfg._params = dict(self._params)
        cfg._scopes = set(self._scopes)
        cfg.config_version = self.config_version
        return cfg

    # ----------------------------------------------------- self-documentation
    def write_parameters_description(self) -> str:
        """Dump the registry (reference: AMGX_write_parameters_description)."""
        out = {}
        for name, desc in sorted(all_parameters().items()):
            entry = {"default": desc.default, "description": desc.description,
                     "type": desc.type.__name__}
            if desc.allowed:
                entry["allowed"] = list(desc.allowed)
            if desc.range:
                entry["range"] = list(desc.range)
            out[name] = entry
        return json.dumps(out, indent=2)

    def __repr__(self):
        n = len(self._params)
        return f"AMGConfig({n} params, scopes={sorted(self._scopes)})"
