"""Constraint evaluation: linearize circuit DAGs and interpret them on
the host (Python-int XFE arithmetic; used by the verifier at the OOD point
and by tests). The prover's quotient runs the
same DAGs as compiled tapes on tensors (air/compile.py).

Replaces the reference's build-time Rust codegen
(triton-constraint-builder/src/codegen.rs) with runtime interpretation.
"""

from __future__ import annotations

from ..fields import xfe as sxfe
from ..fields.bfe import P
from . import circuit as C


def linearize(exprs):
    """Topologically ordered op list for the given constraint Exprs.

    Returns (steps, out_ids) where steps is a list of
    (node_id, kind, payload):
      ('bconst', int) | ('xconst', (c0,c1,c2)) | ('input', (kind, col)) |
      ('challenge', idx) | ('binop', (op, lhs_id, rhs_id))
    """
    steps = []
    seen = set()

    def visit(node):
        stack = [(node, False)]
        while stack:
            n, expanded = stack.pop()
            if n.id in seen:
                continue
            if n.kind != "binop":
                seen.add(n.id)
                steps.append((n.id, n.kind, n.value))
                continue
            if expanded:
                seen.add(n.id)
                steps.append((n.id, "binop", (n.op, n.lhs.id, n.rhs.id)))
            else:
                stack.append((n, True))
                stack.append((n.rhs, False))
                stack.append((n.lhs, False))

    for e in exprs:
        visit(e.node)
    return steps, [e.node.id for e in exprs]


def eval_host(steps, out_ids, main_row, aux_row, challenges,
              next_main_row=None, next_aux_row=None):
    """Scalar evaluation; rows are lists of XFE tuples (BFE ints allowed,
    lifted on the fly). Returns list of XFE tuples."""
    def lift(v):
        return v if isinstance(v, tuple) else sxfe.lift(v)

    env = {}
    for nid, kind, payload in steps:
        if kind == "bconst":
            env[nid] = sxfe.lift(payload)
        elif kind == "xconst":
            env[nid] = payload
        elif kind == "challenge":
            env[nid] = tuple(challenges[payload])
        elif kind == "input":
            ik, col = payload
            if ik == C.MAIN:
                env[nid] = lift(main_row[col])
            elif ik == C.AUX:
                env[nid] = lift(aux_row[col])
            elif ik == C.NEXT_MAIN:
                env[nid] = lift(next_main_row[col])
            else:
                env[nid] = lift(next_aux_row[col])
        else:
            op, lid, rid = payload
            if op == "+":
                env[nid] = sxfe.add(env[lid], env[rid])
            else:
                env[nid] = sxfe.mul(env[lid], env[rid])
    return [env[i] for i in out_ids]


def substitution_pairs(subs):
    """Extract (input_kind, col, rhs_expr_node) from substitution Exprs
    of the shape `new_var + (-1)*expr` (circuit.py lower_to_degree)."""
    out = []
    for s in subs:
        node = s.node
        assert node.kind == "binop" and node.op == "+"
        var = node.lhs
        neg = node.rhs
        assert var.kind == "input", "unexpected substitution shape"
        assert neg.kind == "binop" and neg.op == "*"
        assert neg.lhs.kind == "bconst" and neg.lhs.value == P - 1
        out.append((var.value[0], var.value[1], neg.rhs))
    return out

