"""Program inspection: pretty-printer + graphviz export (the port's copy
of `paddle_tpu/debugger.py`: the same text for the same Program).

The reference's debuger.py/graphviz.py/net_drawer.py (fluid program
dumps, SURVEY §5 observability). `program_to_code` renders a readable
listing; `draw_program` emits graphviz dot (vars as ellipses, ops as
boxes, sub-blocks as clusters) for `dot -Tpng`.
"""

from __future__ import annotations

__all__ = ["program_to_code", "draw_program"]


def _fmt_attr(v):
    s = repr(v)
    return s if len(s) <= 40 else s[:37] + "..."


def program_to_code(program):
    """fluid debuger.py program_to_code analog."""
    lines = []
    for blk in program.blocks:
        lines.append(f"// block {blk.idx} (parent {blk.parent_idx})")
        for var in blk.vars.values():
            mods = []
            if var.persistable:
                mods.append("persist")
            if var.trainable:
                mods.append("param")
            if var.lod_level:
                mods.append(f"lod={var.lod_level}")
            mod = (" [" + ",".join(mods) + "]") if mods else ""
            lines.append(f"var {var.name} : {var.dtype}"
                         f"{list(var.shape or [])}{mod}")
        for op in blk.ops:
            ins = ", ".join(f"{k}={v}" for k, v in op.inputs.items() if v)
            outs = ", ".join(f"{k}={v}" for k, v in op.outputs.items()
                             if v)
            attrs = ", ".join(f"{k}={_fmt_attr(v)}"
                              for k, v in sorted(op.attrs.items()))
            lines.append(f"  {{{outs}}} = {op.type}({ins})"
                         + (f" {{{attrs}}}" if attrs else ""))
    return "\n".join(lines)


def draw_program(program, path=None, name="program"):
    """Emit graphviz dot for the program; optionally write to `path`.
    Render with `dot -Tpng program.dot -o program.png`."""
    lines = [f"digraph {name} {{", "  rankdir=TB;"]
    n = 0

    def var_node(blk_idx, vname):
        return f"v_{blk_idx}_{vname}".replace("@", "_").replace(".", "_")

    seen_vars = set()
    for blk in program.blocks:
        if blk.idx > 0:
            lines.append(f"  subgraph cluster_{blk.idx} {{")
            lines.append(f'    label="block {blk.idx}";')
        for op in blk.ops:
            op_id = f"op_{blk.idx}_{n}"
            n += 1
            lines.append(f'  {op_id} [shape=box, style=filled, '
                         f'fillcolor=lightgray, label="{op.type}"];')
            for names in op.inputs.values():
                for vn in names:
                    if not vn:
                        continue
                    node = var_node(blk.idx, vn)
                    if node not in seen_vars:
                        seen_vars.add(node)
                        lines.append(f'  {node} [label="{vn}"];')
                    lines.append(f"  {node} -> {op_id};")
            for names in op.outputs.values():
                for vn in names:
                    if not vn:
                        continue
                    node = var_node(blk.idx, vn)
                    if node not in seen_vars:
                        seen_vars.add(node)
                        lines.append(f'  {node} [label="{vn}"];')
                    lines.append(f"  {op_id} -> {node};")
        if blk.idx > 0:
            lines.append("  }")
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
