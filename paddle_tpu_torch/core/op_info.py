"""Op metadata registry (PyTorch port of ``paddle_tpu/core/op_info.py``):
the OpProto/OpInfoMap analog.

Reference: every C++ op registers an OpProto (inputs/outputs/attrs + docs)
into a global OpInfoMap (paddle/framework/op_registry.h:158, op_info.h).
Here ops are torch closures, so the proto is metadata only; it types the
attr lines of ``Program.to_string``.

Two registration paths:
  - ``register_op(...)``: explicit, with slot docs and a reference citation;
  - ``observe(op)``: automatic, the first recorded instance of an unknown op
    type contributes an INFERRED proto (slot names + attr names/types drawn
    from the live values), so every op in any program is introspectable
    without per-op boilerplate.  Explicit registration always wins.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AttrSpec:
    name: str
    type: str          # 'int' | 'float' | 'bool' | 'str' | value's type name
    default: Any = None
    doc: str = ""


@dataclass
class OpProto:
    """Schema for one op type (ref: framework.proto:62 OpProto)."""

    type: str
    doc: str = ""
    ref: str = ""                                   # reference file:line
    inputs: Dict[str, str] = field(default_factory=dict)   # slot -> doc
    outputs: Dict[str, str] = field(default_factory=dict)
    attrs: Dict[str, AttrSpec] = field(default_factory=dict)
    inferred: bool = False

    def to_string(self) -> str:
        lines = [f"op_proto {self.type}{' (inferred)' if self.inferred else ''}"]
        if self.doc:
            lines.append(f"  doc: {self.doc}")
        if self.ref:
            lines.append(f"  ref: {self.ref}")
        for slot, d in self.inputs.items():
            lines.append(f"  in  {slot}: {d}" if d else f"  in  {slot}")
        for slot, d in self.outputs.items():
            lines.append(f"  out {slot}: {d}" if d else f"  out {slot}")
        for a in self.attrs.values():
            dflt = f" = {a.default!r}" if a.default is not None else ""
            doc = f"  # {a.doc}" if a.doc else ""
            lines.append(f"  attr {a.name}: {a.type}{dflt}{doc}")
        return "\n".join(lines)


_op_info_map: Dict[str, OpProto] = {}


def _attr_type(v) -> str:
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float"
    if isinstance(v, str):
        return "str"
    if isinstance(v, (tuple, list)):
        return "ints" if all(isinstance(e, int) for e in v) else "list"
    return type(v).__name__


def register_op(op_type: str, doc: str = "", ref: str = "",
                inputs: Optional[Dict[str, str]] = None,
                outputs: Optional[Dict[str, str]] = None,
                attrs: Optional[Dict[str, AttrSpec]] = None) -> OpProto:
    """Explicit registration; replaces any inferred proto for the type."""
    proto = OpProto(op_type, doc=doc, ref=ref, inputs=dict(inputs or {}),
                    outputs=dict(outputs or {}), attrs=dict(attrs or {}))
    _op_info_map[op_type] = proto
    return proto


def observe(op) -> None:
    """Contribute an inferred proto from a recorded Op (first sighting only;
    explicit protos are never overwritten)."""
    existing = _op_info_map.get(op.type)
    if existing is not None and not existing.inferred:
        return
    if existing is None:
        existing = OpProto(op.type, inferred=True)
        _op_info_map[op.type] = existing
    for slot in op.inputs:
        existing.inputs.setdefault(slot, "")
    for slot in op.outputs:
        existing.outputs.setdefault(slot, "")
    for k, v in op.attrs.items():
        if k not in existing.attrs and not callable(v):
            existing.attrs[k] = AttrSpec(k, _attr_type(v), default=v)


def get(op_type: str) -> Optional[OpProto]:
    return _op_info_map.get(op_type)


def attr_type(op_type: str, name: str) -> Optional[str]:
    p = _op_info_map.get(op_type)
    a = p.attrs.get(name) if p else None
    return a.type if a else None


def all_protos() -> Dict[str, OpProto]:
    return dict(_op_info_map)
