"""np_products_ms.nonparam: mean milliseconds per window request in the
nonparametric engine's ``np.products`` spans (each Jacobi sweep's Gibbs
kernel-density products, their label draws in K2 and K3;
``solvers/multimodal/batched.py``), host clock."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "np.products")
