"""np_messages_ms.nonparam: mean milliseconds per window request in the
nonparametric engine's ``np.messages`` spans (each Jacobi sweep's messages:
the per-particle Gauss-Newton of every factor toward each of its variables,
scattered into the products' tensors; ``solvers/multimodal/batched.py``),
host clock."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "np.messages")
