"""Program inspection: a pseudo-code printer and a graphviz drawer
(counterpart of ``paddle_tpu/debugger.py``, same output). The drawer
writes a ``.dot`` file; no graphviz binary is needed.
"""
from __future__ import annotations

from .core import ir

__all__ = ["pprint_program_codes", "pprint_block_codes",
           "draw_block_graphviz"]


def _attr_repr(v):
    if isinstance(v, ir.Block):
        return "block[%d]" % v.idx
    r = repr(v)
    return r if len(r) <= 40 else r[:37] + "..."


def pprint_block_codes(block, show_backward=False):
    """One block as pseudo-code lines: its vars, then its ops (the
    ``*_grad`` ops only with ``show_backward``)."""
    lines = ["// block %d, parent %d" % (block.idx, block.parent_idx)]
    for v in block.vars.values():
        kind = "param" if isinstance(v, ir.Parameter) else (
            "persist" if v.persistable else "var")
        lines.append("%s %s : %s%s" % (
            kind, v.name, getattr(v.dtype, "name", v.dtype),
            list(v.shape) if v.shape else "?"))
    for op in block.ops:
        if not show_backward and op.type.endswith("_grad"):
            continue
        outs = ", ".join(op.output_arg_names)
        ins = ", ".join(op.input_arg_names)
        attrs = ", ".join("%s=%s" % (k, _attr_repr(v))
                          for k, v in sorted(op.attrs.items()))
        lines.append("%s = %s(%s)%s" % (
            outs, op.type, ins, (" {%s}" % attrs) if attrs else ""))
    return "\n".join(lines)


def pprint_program_codes(program, show_backward=False):
    """Every block of ``program`` as pseudo-code."""
    return "\n\n".join(pprint_block_codes(b, show_backward)
                       for b in program.blocks)


def draw_block_graphviz(block, highlights=None, path="./temp.dot",
                        op_highlights=None):
    """Write a graphviz .dot of the block's op / var dataflow to ``path``
    and return its text. ``highlights``: var names to fill yellow.
    ``op_highlights``: op indices to fill red (the lint verb marks the
    ops with error diagnostics)."""
    highlights = set(highlights or ())
    op_highlights = set(op_highlights or ())
    lines = ["digraph G {", "  rankdir=TB;"]
    seen_vars = set()

    def var_node(name):
        nid = "var_" + name.replace("@", "_").replace(".", "_")
        if name not in seen_vars:
            seen_vars.add(name)
            color = ', style=filled, fillcolor="#ffd866"' \
                if name in highlights else ""
            shape = "box"
            try:
                v = block.var(name)
                if isinstance(v, ir.Parameter):
                    shape = "box3d"
            except KeyError:
                pass
            lines.append('  %s [label="%s", shape=%s%s];'
                         % (nid, name, shape, color))
        return nid

    for i, op in enumerate(block.ops):
        onid = "op_%d" % i
        color = "#ff6188" if i in op_highlights else "#a9dcdf"
        lines.append('  %s [label="%s", shape=ellipse, style=filled, '
                     'fillcolor="%s"];' % (onid, op.type, color))
        for n in op.input_arg_names:
            lines.append("  %s -> %s;" % (var_node(n), onid))
        for n in op.output_arg_names:
            lines.append("  %s -> %s;" % (onid, var_node(n)))
    lines.append("}")
    text = "\n".join(lines)
    with open(path, "w") as f:
        f.write(text + "\n")
    return text
