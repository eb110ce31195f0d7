"""The one place a plan that needs a module this package has not ported yet
stops. The planner and metadata modules are copies of the reference's, and
their lazy imports of such modules are replaced by calls here."""

from __future__ import annotations

from .sql.functions import VECTOR_SCALAR_FUNCTIONS
from .sql.ir import Call, Case, CastExpr

_MODEL_CALLS = ("$linear_model", "$gbdt_model")


def unported(module: str):
    raise NotImplementedError(f"{module} is not ported to trino_tpu_torch yet")


def vector_dimension_problems(expr):
    """Stands in for ``ops.tensor.vector_dimension_problems`` in the sanity
    checker: an expression without a tensor-plane call has no problems to
    report, and one with such a call needs ``ops.tensor``."""
    stack = [expr]
    while stack:
        e = stack.pop()
        if isinstance(e, Call):
            if e.name in VECTOR_SCALAR_FUNCTIONS or e.name in _MODEL_CALLS:
                unported("ops.tensor")
            stack.extend(e.args)
        elif isinstance(e, CastExpr):
            stack.append(e.value)
        elif isinstance(e, Case):
            for c, r in e.whens:
                stack.extend((c, r))
            if e.default is not None:
                stack.append(e.default)
    return ()
