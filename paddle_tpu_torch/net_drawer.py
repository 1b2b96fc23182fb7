"""Program graph visualisation (PyTorch port of ``paddle_tpu/net_drawer.py``;
ref: python/paddle/v2/fluid/net_drawer.py — the reference renders a
ProgramDesc as graphviz for debugging; same capability over the port's
Program IR, the JAX package's dot text for the same program).

``draw(program)`` returns graphviz dot text; ``draw(program, path)`` also
writes it (and renders to an image when the ``graphviz`` binary/package is
available — neither is required)."""
from __future__ import annotations

from typing import Optional

from .core.program import Program, default_main_program

_OP_STYLE = 'shape=box, style="rounded,filled", fillcolor="#cde8f7"'
_VAR_STYLE = 'shape=ellipse, fillcolor="#e8e8e8", style=filled'
_PARAM_STYLE = 'shape=ellipse, fillcolor="#ffe9b0", style=filled'


def _q(name: str) -> str:
    return '"' + name.replace('"', "'") + '"'


def draw(program: Optional[Program] = None, path: Optional[str] = None,
         graph_name: str = "program") -> str:
    """Emit graphviz dot for a Program's global block: ops as boxes, variables
    as ellipses (parameters highlighted), edges following def-use."""
    program = program or default_main_program()
    block = program.global_block
    params = {p.name for p in program.parameters()}

    lines = [f"digraph {_q(graph_name)} {{", "  rankdir=TB;"]
    seen_vars = set()

    def var_node(n):
        if n in seen_vars:
            return
        seen_vars.add(n)
        style = _PARAM_STYLE if n in params else _VAR_STYLE
        lines.append(f"  {_q(n)} [{style}];")

    for i, op in enumerate(block.ops):
        op_id = f"op_{i}_{op.type}"
        label = op.type
        if op.attrs:
            keys = ", ".join(sorted(op.attrs)[:3])
            label = f"{op.type}\\n({keys})"
        lines.append(f'  {_q(op_id)} [{_OP_STYLE}, label="{label}"];')
        for n in op.input_names():
            var_node(n)
            lines.append(f"  {_q(n)} -> {_q(op_id)};")
        for n in op.output_names():
            var_node(n)
            lines.append(f"  {_q(op_id)} -> {_q(n)};")
    lines.append("}")
    dot = "\n".join(lines) + "\n"

    if path:
        with open(path, "w") as f:
            f.write(dot)
        try:  # optional rendering, like the reference's graphviz dependency
            import subprocess

            subprocess.run(["dot", "-Tpng", path, "-o", path + ".png"],
                           capture_output=True, timeout=30)
        except Exception:
            pass
    return dot
