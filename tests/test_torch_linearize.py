"""Linearization of the port against the JAX package.

- K1's plain version (ops/fused_linearize.pose2pose2_linearize_plain, what
  the wrapper computes on CPU tensors) against JAX's
  ops/fused_linearize.pose2pose2_linearize times the weight, at n in
  {1, 100, 1024, 10000, 13085}: atol 2e-5 in float32 (the tolerance of
  tests/test_linearize_pallas.py:38), 1e-10 in float64.
- The same against the Pallas kernel (interpret mode, as the JAX package's
  tests run it) only at n <= 1024: its grid drops the last partial block
  for n > 8192, so it is not a reference there.
- linearize_all, linearize_all_mixed_j, cost_at, the gradient, the Hvp, the
  block diagonal, normal_eq_entry_values and dense_normal_eqs on a grid
  graph, both packages fed the same lowered arrays.
- The CUDA kernel itself runs only on a card (marker ``cuda``).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu.ops.fused_linearize import pose2pose2_linearize as jax_fused  # noqa: E402
from rome_tpu.ops.linearize_pallas import pose2pose2_linearize_packed  # noqa: E402
from rome_tpu.solvers import linearize as JL  # noqa: E402
from rome_tpu_torch.ops import linearize_cuda as K  # noqa: E402
from rome_tpu_torch.ops import nvcc_build as NB  # noqa: E402
from rome_tpu_torch.ops.fused_linearize import pose2pose2_linearize_plain  # noqa: E402
from rome_tpu_torch.solvers import linearize as TL  # noqa: E402
from test_torch_helpers import grid_graph, port_arrays  # noqa: E402

ATOL = {"float32": 2e-5, "float64": 1e-10}


def _batch(n, seed=0):
    """Random Pose2Pose2 batch, as tests/test_linearize_pallas.py makes it."""
    rng = np.random.default_rng(seed)
    return (
        rng.normal(0, 2, (n, 3)), rng.normal(0, 2, (n, 3)), rng.normal(0, 1, (n, 3)),
        rng.normal(0, 1, (n, 3, 3)) + 5 * np.eye(3), rng.uniform(0.5, 1, (n,)),
    )


def _jax_weighted(p, q, z, S, w):
    r, (J1, J2) = jax_fused({"z": z, "sqrt_info": S}, p, q)
    return (np.asarray(r * w[:, None]), np.asarray(J1 * w[:, None, None]),
            np.asarray(J2 * w[:, None, None]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 100, 1024, 10000, 13085])
def test_plain_matches_jax_fused(n, dtype):
    arrs = [a.astype(dtype) for a in _batch(n)]
    with jax.enable_x64():
        want = _jax_weighted(*(jnp.asarray(a) for a in arrs))
    r, (J1, J2) = pose2pose2_linearize_plain(*(torch.as_tensor(a) for a in arrs))
    for got, ref in zip((r, J1, J2), want):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("n", [1, 100, 200, 1024])
def test_plain_matches_pallas_kernel(n):
    p, q, z, S, w = (a.astype(np.float32) for a in _batch(n, seed=1))
    r_p, (J1_p, J2_p) = pose2pose2_linearize_packed(
        {"z": jnp.asarray(z), "sqrt_info": jnp.asarray(S)},
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(w),
    )
    r, (J1, J2) = K.pose2pose2_linearize(*(torch.as_tensor(a) for a in (p, q, z, S, w)))
    for got, ref in zip((r, J1, J2), (r_p, J1_p, J2_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


def test_wrapper_takes_plain_path_on_cpu_and_counts_no_launch():
    args = [torch.as_tensor(a) for a in _batch(50, seed=2)]
    before = dict(K.LAUNCHES)
    got = K.pose2pose2_linearize(*args)
    want = pose2pose2_linearize_plain(*args)
    assert K.LAUNCHES == before
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1][0], want[1][0], rtol=0, atol=0)


@pytest.mark.parametrize(
    "bad",
    ["dtype_mix", "shape", "noncontig", "int", "meta_device"],
)
def test_wrapper_rejects_bad_inputs(bad):
    args = [torch.as_tensor(a) for a in _batch(8, seed=3)]
    if bad == "dtype_mix":
        args[2] = args[2].float()
    elif bad == "shape":
        args[3] = args[3][:, :2]
    elif bad == "noncontig":
        args[0] = torch.as_tensor(np.asfortranarray(args[0].numpy()))
    elif bad == "int":
        args = [a.to(torch.int64) for a in args]
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises((TypeError, ValueError)):
        K.pose2pose2_linearize(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 1000, 8192, 10000, 13085])
def test_cuda_kernel_matches_plain(cuda_device, n, dtype):
    args = [torch.as_tensor(a, dtype=getattr(torch, dtype), device=cuda_device)
            for a in _batch(n, seed=4)]
    before = K.LAUNCHES["lin"]
    got = K.pose2pose2_linearize(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["lin"] == before + 1
    want = pose2pose2_linearize_plain(*args)
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL[dtype])


# ---------------------------------------------------------------------------
# whole-graph linearization on a grid
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid_pair():
    """(JAX GraphArrays, port GraphArrays, evaluation point, tangent vector,
    the JAX package's results) in float64, with two frozen poses and a
    perturbed evaluation point. The JAX side runs jitted (its eager
    dispatch is slow on the CPU)."""
    rng = np.random.default_rng(8)
    u = rng.normal(0, 1, (25, 3))
    with jax.enable_x64():
        fg = grid_graph(R, 5, 5, seed=7, frozen=("x4", "x12"))
        ga = jax_lower(fg, dtype=jnp.float64)
        v = np.asarray(ga.values0["Pose2"]) + rng.normal(0, 0.1, (25, 3))

        def run(v, u, rt):
            vj = {"Pose2": v}
            lins = JL.linearize_all(ga, vj, rt)
            return {
                "lins": [(r, Js) for _b, r, Js, _v in lins],
                "cost": JL.cost_at(ga, vj, rt),
                "gradient": JL.gradient_from_lins(ga, lins, rt)["Pose2"],
                "hvp": JL.hvp_from_lins(ga, lins, {"Pose2": u}, rt)["Pose2"],
                "block_diag": JL.block_diag_from_lins(ga, lins)["Pose2"],
                "entry_values": JL.normal_eq_entry_values(ga, lins),
                "dense_normal_eqs": JL.dense_normal_eqs(ga, lins, rt=rt),
            }

        want = jax.tree_util.tree_map(
            np.asarray, jax.jit(run)(jnp.asarray(v), jnp.asarray(u), JL.runtime_state(ga))
        )
    return ga, port_arrays(ga), v, u, want


def test_linearize_all_matches(grid_pair):
    _ga, tg, v, _u, want = grid_pair
    lt = TL.linearize_all(tg, {"Pose2": torch.as_tensor(v)}, TL.runtime_state(tg))
    assert [b.ftype.name for b, *_ in lt] == ["PriorPose2", "Pose2Pose2"]
    for (rj, Jj), (_b, rt, Jt, _v) in zip(want["lins"], lt):
        np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=1e-10)
        for a, b in zip(Jt, Jj):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-10)


def test_linearize_all_mixed_j_matches(grid_pair):
    """f64 residuals + f32 Jacobians (the ndchol path's linearization), on
    the float32-lowered graph with float64 values, as the JAX package's
    ndchol solver calls it."""
    _ga, _tg, v, _u, _want = grid_pair
    with jax.enable_x64():
        ga32 = jax_lower(grid_graph(R, 5, 5, seed=7, frozen=("x4", "x12")))
        ga64 = copy.copy(ga32)
        ga64.dtype = jnp.float64
        lj = jax.jit(lambda v, rt: [
            (r, Js) for _b, r, Js, _v in JL.linearize_all_mixed_j(ga64, ga32, {"Pose2": v}, rt)
        ])(jnp.asarray(v), JL.runtime_state(ga32))
        lj = jax.tree_util.tree_map(np.asarray, lj)
    tg32 = port_arrays(ga32)
    tg64 = copy.copy(tg32)
    tg64.dtype = torch.float64
    lt, _parts = TL.linearize_all_mixed_j(
        tg64, tg32, {"Pose2": torch.as_tensor(v)}, TL.runtime_state(tg32))
    for (rj, Jj), (_b, rt, Jt, _v) in zip(lj, lt):
        assert rt.dtype == torch.float64 and all(J.dtype == torch.float32 for J in Jt)
        np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=1e-10)
        for a, b in zip(Jt, Jj):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-5)


@pytest.mark.parametrize(
    "what", ["cost", "gradient", "hvp", "block_diag", "entry_values", "dense_normal_eqs"]
)
def test_consumers_of_lins_match(grid_pair, what):
    _ga, tg, v, u, want = grid_pair
    rtt = TL.runtime_state(tg)
    vt = {"Pose2": torch.as_tensor(v)}
    lt = TL.linearize_all(tg, vt, rtt)
    got = {
        "cost": lambda: TL.cost_at(tg, vt, rtt),
        "gradient": lambda: TL.gradient_from_lins(tg, lt, rtt)["Pose2"],
        "hvp": lambda: TL.hvp_from_lins(tg, lt, {"Pose2": torch.as_tensor(u)}, rtt)["Pose2"],
        "block_diag": lambda: TL.block_diag_from_lins(tg, lt)["Pose2"],
        "entry_values": lambda: TL.normal_eq_entry_values(tg, lt),
        "dense_normal_eqs": lambda: TL.dense_normal_eqs(tg, lt, rt=rtt),
    }[what]()
    got = list(got) if isinstance(got, tuple) else [got]
    ref = want[what]
    ref = list(ref) if isinstance(ref, tuple) else [ref]
    for g, w in zip(got, ref):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-9)


def test_generic_path_matches_fused_path(grid_pair):
    """vmap(jacfwd) of the Pose2Pose2 residual agrees with the closed form."""
    _ga, tg, v, _u, _want = grid_pair
    b = tg.batches[1]
    vals = {"Pose2": torch.as_tensor(v)}
    r_f, J_f = TL.batch_linearize(tg, b, vals)
    r_g, J_g = TL.batch_linearize(tg, b, vals, fused=False)
    torch.testing.assert_close(r_g, r_f, rtol=0, atol=1e-12)
    for a, c in zip(J_g, J_f):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-12)


def test_tangent_layout_matches(grid_pair):
    ga, tg, _v, _u, _want = grid_pair
    base_j, D_j = JL.tangent_offsets(ga)
    base_t, D_t = TL.tangent_offsets(tg)
    assert (base_t, D_t) == (base_j, D_j)
    x = np.arange(D_t, dtype=np.float64)
    ut = TL.unflatten_tangent(tg, torch.as_tensor(x))
    np.testing.assert_array_equal(TL.flatten_tangent(tg, ut).numpy(), x)
    with jax.enable_x64():
        fj = np.asarray(JL.free_vector(ga))
    np.testing.assert_array_equal(TL.free_vector(tg).numpy(), fj)


def test_kernel_build_is_keyed_by_source_flags_and_nvcc(tmp_path, monkeypatch):
    """The cached library is rebuilt when the nvcc flags or the nvcc version
    change, not only when the source does (a fake nvcc stands in here)."""
    import stat
    import sys

    log = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import os, sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "if '--version' in sys.argv:\n"
        "    print('fake nvcc', os.environ.get('FAKE_NVCC_VERSION', '1'))\n"
        "else:\n"
        "    open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(NB, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(NB, "BUILD_DIR", tmp_path / "build")

    def compiles():
        return sum("-o" in ln.split() for ln in log.read_text().splitlines())

    first = K.build()
    assert K.build() == first and compiles() == 1
    monkeypatch.setattr(NB, "NVCC_FLAGS", NB.NVCC_FLAGS + ("--use_fast_math",))
    flagged = K.build()
    assert flagged != first and compiles() == 2
    monkeypatch.setenv("FAKE_NVCC_VERSION", "2")
    assert K.build() not in (first, flagged) and compiles() == 3
