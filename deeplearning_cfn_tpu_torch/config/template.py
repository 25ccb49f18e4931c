"""Declarative cluster templates.

The reference ships CloudFormation templates with four declarative features
the operators actually use: typed ``Parameters`` with defaults and
AllowedValues (deeplearning.template:4-108), per-region ``Mappings``
(:112-151), boolean ``Conditions`` gating resources (:109-111, e.g. create
EFS only when EFSFileSystemId is blank; EFSServesData in
mask-rcnn-cfn.yaml:226-228), and ``Ref``/``Fn::FindInMap`` substitution.

This module reimplements that surface over plain JSON templates that render
to a validated :class:`ClusterSpec`.  Templates are data, not code, so they
can be checked in, diffed, and parameterized per launch — the property that
made the reference's stack reproducible.

Template shape::

    {
      "Parameters": {"WorkerCount": {"type": "int", "default": 2,
                                      "allowed": [1, 2, 4], "min": 1}},
      "Mappings":   {"ZoneDefaults": {"us-central2-b": {"runtime": "..."}}},
      "Conditions": {"CreateStorage": {"equals": [{"ref": "StorageId"}, ""]}},
      "Cluster":    {... ClusterSpec fields, with {"ref": ...} /
                     {"find_in_map": [map, key, field]} /
                     {"if": [cond, then, else]} substitutions ...}
    }

Counterpart of ``deeplearning_cfn_tpu/config/template.py``, copied: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from deeplearning_cfn_tpu_torch.config.schema import ClusterSpec, ConfigError

_TYPES = {"str": str, "int": int, "float": float, "bool": bool}


def load_template(path: str | Path) -> dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _coerce(name: str, decl: dict[str, Any], value: Any) -> Any:
    ty = _TYPES.get(decl.get("type", "str"), str)
    try:
        if ty is bool and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes")
        else:
            value = ty(value)
    except (TypeError, ValueError) as e:
        raise ConfigError(f"parameter {name!r}: cannot coerce {value!r} to {ty.__name__}") from e
    allowed = decl.get("allowed")
    if allowed is not None and value not in allowed:
        raise ConfigError(f"parameter {name!r}: {value!r} not in allowed values {allowed}")
    if "min" in decl and value < decl["min"]:
        raise ConfigError(f"parameter {name!r}: {value!r} < min {decl['min']}")
    if "max" in decl and value > decl["max"]:
        raise ConfigError(f"parameter {name!r}: {value!r} > max {decl['max']}")
    return value


def resolve_parameters(
    template: dict[str, Any], overrides: dict[str, Any] | None = None
) -> dict[str, Any]:
    """Merge operator overrides into declared parameters, enforcing types,
    AllowedValues, and required-ness (no default => required)."""
    decls: dict[str, Any] = template.get("Parameters", {})
    overrides = dict(overrides or {})
    params: dict[str, Any] = {}
    for name, decl in decls.items():
        if name in overrides:
            params[name] = _coerce(name, decl, overrides.pop(name))
        elif "default" in decl:
            params[name] = _coerce(name, decl, decl["default"])
        else:
            raise ConfigError(f"parameter {name!r} is required (no default)")
    if overrides:
        raise ConfigError(f"unknown parameters: {sorted(overrides)}")
    return params


def _eval_condition(expr: Any, params: dict[str, Any], mappings: dict[str, Any]) -> bool:
    if isinstance(expr, bool):
        return expr
    if not isinstance(expr, dict) or len(expr) != 1:
        raise ConfigError(f"bad condition expression: {expr!r}")
    (op, arg), = expr.items()
    sub = lambda v: _substitute(v, params, mappings, {})  # noqa: E731
    if op == "equals":
        a, b = arg
        return sub(a) == sub(b)
    if op == "not":
        return not _eval_condition(arg, params, mappings)
    if op == "and":
        return all(_eval_condition(a, params, mappings) for a in arg)
    if op == "or":
        return any(_eval_condition(a, params, mappings) for a in arg)
    raise ConfigError(f"unknown condition op {op!r}")


def _substitute(
    node: Any,
    params: dict[str, Any],
    mappings: dict[str, Any],
    conditions: dict[str, bool],
) -> Any:
    if isinstance(node, dict):
        if set(node) == {"ref"}:
            name = node["ref"]
            if name not in params:
                raise ConfigError(f"ref to undeclared parameter {name!r}")
            return params[name]
        if set(node) == {"find_in_map"}:
            map_name, key, fld = node["find_in_map"]
            key = _substitute(key, params, mappings, conditions)
            try:
                return mappings[map_name][key][fld]
            except KeyError as e:
                raise ConfigError(
                    f"find_in_map failed: [{map_name}][{key}][{fld}]"
                ) from e
        if set(node) == {"if"}:
            cond_name, then_v, else_v = node["if"]
            if cond_name not in conditions:
                raise ConfigError(f"if refers to unknown condition {cond_name!r}")
            chosen = then_v if conditions[cond_name] else else_v
            return _substitute(chosen, params, mappings, conditions)
        return {
            k: _substitute(v, params, mappings, conditions) for k, v in node.items()
        }
    if isinstance(node, list):
        return [_substitute(v, params, mappings, conditions) for v in node]
    return node


def render_template(
    template: dict[str, Any], parameters: dict[str, Any] | None = None
) -> ClusterSpec:
    """Parameters + Mappings + Conditions + Cluster body -> validated spec."""
    params = resolve_parameters(template, parameters)
    mappings = template.get("Mappings", {})
    conditions = {
        name: _eval_condition(expr, params, mappings)
        for name, expr in template.get("Conditions", {}).items()
    }
    body = template.get("Cluster")
    if body is None:
        raise ConfigError("template missing 'Cluster' section")
    rendered = _substitute(body, params, mappings, conditions)
    return ClusterSpec.from_dict(rendered)


def render_template_file(
    path: str | Path, parameters: dict[str, Any] | None = None
) -> ClusterSpec:
    return render_template(load_template(path), parameters)
