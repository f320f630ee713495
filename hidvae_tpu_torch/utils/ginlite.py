"""Minimal gin parser (a copy of hidvae_tpu/utils/ginlite.py, its enums
the port's): comments, imports, `scope.param = value` literals, lists and
`%module.Enum.MEMBER`."""

import ast
import re
from enum import Enum
from typing import Any, Dict

_ENUM_REGISTRY: Dict[str, Any] = {}


def register_enum(cls, *aliases: str):
    """Register an enum class under its own name and any alias paths."""
    names = {cls.__name__, *aliases}
    for n in names:
        _ENUM_REGISTRY[n] = cls
    return cls


def _register_builtin_enums():
    from hidvae_tpu_torch.data.processed import RecDataset
    from hidvae_tpu_torch.models.quantize import QuantizeForwardMode
    from hidvae_tpu_torch.ops.distances import DistanceMode

    register_enum(QuantizeForwardMode, "modules.quantize.QuantizeForwardMode")
    register_enum(DistanceMode, "modules.quantize.QuantizeDistance", "QuantizeDistance")
    register_enum(
        RecDataset,
        "data.processed.RecDataset",
        "data.tags_processed.RecDataset",
        "data.load_kuairand.RecDataset",
    )


def _resolve_enum(ref: str):
    """Resolve `%a.b.EnumName.MEMBER` (leading % stripped)."""
    if not _ENUM_REGISTRY:
        _register_builtin_enums()
    parts = ref.split(".")
    member = parts[-1]
    for depth in range(len(parts) - 1, 0, -1):
        path = ".".join(parts[:depth])
        cls = _ENUM_REGISTRY.get(path)
        if cls is not None and issubclass(cls, Enum):
            return cls[member]
    raise ValueError(f"Unknown enum reference %{ref}")


def _parse_value(text: str):
    text = text.strip()
    if text.startswith("%"):
        return _resolve_enum(text[1:])
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        if not inner:
            return []
        # Split at top level (no nested lists in the reference configs).
        return [_parse_value(t) for t in inner.split(",")]
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text  # bare string


_BINDING_RE = re.compile(r"^([A-Za-z_][\w.]*)\s*=\s*(.+)$")


def parse_gin_file(path: str) -> Dict[str, Dict[str, Any]]:
    """Parse a gin file into {scope: {param: value}} ('train' is the scope of
    `train.foo = bar`). Multi-line list bindings are joined."""
    with open(path) as f:
        raw_lines = f.readlines()

    # Join continuation lines for multi-line lists.
    lines, buf = [], ""
    for line in raw_lines:
        line = line.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        buf = (buf + " " + line.strip()).strip() if buf else line.strip()
        if buf.count("[") > buf.count("]"):
            continue
        lines.append(buf)
        buf = ""
    if buf:
        lines.append(buf)

    scopes: Dict[str, Dict[str, Any]] = {}
    imports = []
    for line in lines:
        if line.startswith("import "):
            imports.append(line[len("import "):].strip())
            continue
        m = _BINDING_RE.match(line)
        if m is None:
            raise ValueError(f"Cannot parse gin line: {line!r}")
        dotted, value = m.group(1), m.group(2)
        if "." in dotted:
            scope, param = dotted.rsplit(".", 1)
        else:
            scope, param = "", dotted
        scopes.setdefault(scope, {})[param] = _parse_value(value)
    scopes.setdefault("__imports__", {})["modules"] = imports
    return scopes


def bind_to_kwargs(
    config: Dict[str, Dict[str, Any]],
    scope: str,
    fn,
    *,
    strict: bool = True,
) -> Dict[str, Any]:
    """Bind a scope's parameters to fn's keyword parameters. Unknown
    bindings raise, as gin does; `strict=False` makes them a warning."""
    import inspect
    import logging

    params = inspect.signature(fn).parameters
    bound, unknown = {}, []
    for k, v in config.get(scope, {}).items():
        if k in params:
            bound[k] = v
        else:
            unknown.append(k)
    if unknown:
        msg = (
            f"Unknown gin binding(s) for {scope!r}: {sorted(unknown)} — "
            f"not parameters of {getattr(fn, '__qualname__', fn)}"
        )
        if strict:
            raise ValueError(msg)
        logging.getLogger("hidvae_tpu_torch.ginlite").warning(msg)
    return bound
