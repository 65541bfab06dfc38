"""One message's per-particle Gauss-Newton as a keyed device program
(``solvers/multimodal/convolve._GNProgram``): on the CPU the program runs
its phase eagerly through the same copy-in / clone-out path, and equals the
plain initializer + ``_gn_solve_target`` bit for bit on the five beehive
(factor type, slot) messages; a key's static buffers hold no stale input and
alias no output; the cache is keyed by particle count (its bound is
tests/test_torch_tracing.py's); the engine's counters count calls on the
host. On the card (``cuda``
marker, skipped here) the captured replay equals the program's eager run.
The file imports no jax: ``pytest --noconftest`` runs it on the card."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rome_tpu_torch import generate_graph_beehive  # noqa: E402
from rome_tpu_torch.solvers.multimodal import convolve  # noqa: E402
from rome_tpu_torch.utils import profiling  # noqa: E402

F32 = torch.float32
# the beehive's messages: (factor type, target slot)
CASES = [("PriorPose2", 0), ("Pose2Pose2", 0), ("Pose2Pose2", 1),
         ("Pose2Point2BearingRange", 0), ("Pose2Point2BearingRange", 1)]


@pytest.fixture(scope="module")
def beehive():
    fg = generate_graph_beehive(pose_count_target=10, seed=0, graphinit=False)
    fg.init_all("default")
    return fg


def _message(fg, name, slot, M, seed, device="cpu"):
    """The inputs of one message toward ``slot`` of the graph's first
    ``name`` factor, as the batched engine hands them over: particles of each
    variable around its closed-form point, measurement samples, an inflated
    start, and the factor's params broadcast to M rows (stride-0 views)."""
    f = next(fg.factors[label] for label in fg._fct_order if fg.factors[label].ftype.name == name)
    gen = torch.Generator().manual_seed(seed)
    mans = [fg.variables[v].manifold for v in f.variables]

    def around(point, scale):
        p = torch.as_tensor(point, dtype=F32)
        return p + scale * torch.randn((M, p.shape[0]), generator=gen, dtype=F32)

    pts = [around(fg.variables[v].points["default"], 0.3) for v in f.variables]
    z = around(f.params["z"], 0.05)
    x0 = around(fg.variables[f.variables[slot]].points["default"], 0.5)
    params = {k: torch.as_tensor(v, dtype=F32).expand(M, *v.shape)
              for k, v in f.params.items()}
    move = {"device": device}
    return (f.ftype, slot, mans, {k: v.to(**move) for k, v in params.items()}, z.to(**move),
            x0.to(**move), [p.to(**move) for p in pts])


def _plain(ftype, slot, mans, params, z, x0, pts):
    """The message as the engine solved it before its program: the slot's
    initializer (else x0), then ``_gn_solve_target``, eagerly."""
    init_fn = ftype.initializers.get(slot)
    x = init_fn({**params, "z": z}, list(pts)) if init_fn is not None else x0
    return convolve._gn_solve_target(ftype, slot, mans, z, params, pts, x)


@pytest.fixture(autouse=True)
def fresh_cache():
    convolve._PROGRAMS.clear()
    yield
    convolve._PROGRAMS.clear()


@pytest.mark.parametrize("name,slot", CASES)
def test_the_keyed_program_is_the_eager_solve_bit_for_bit(beehive, name, slot):
    args = _message(beehive, name, slot, 64, seed=3 + slot)
    got = convolve.conv_particles(*args)
    want = _plain(*args)
    assert got.dtype == F32 and got.shape == args[5].shape
    assert torch.equal(got, want)
    assert len(convolve._PROGRAMS) == 1


def test_successive_calls_of_one_key_return_their_own_answers(beehive):
    first = _message(beehive, "Pose2Pose2", 1, 64, seed=1)
    second = _message(beehive, "Pose2Pose2", 1, 64, seed=2)
    a = convolve.conv_particles(*first)
    kept = a.clone()
    b = convolve.conv_particles(*second)
    assert len(convolve._PROGRAMS) == 1
    assert torch.equal(b, _plain(*second)) and not torch.equal(a, b)
    # the first answer is its own tensor: the second call left it unchanged
    assert torch.equal(a, kept) and torch.equal(a, _plain(*first))
    program = next(iter(convolve._PROGRAMS.values()))
    assert a.data_ptr() != program.out.data_ptr() != b.data_ptr()


def test_particle_counts_key_their_own_programs(beehive):
    for M in (32, 48, 32):
        convolve.conv_particles(*_message(beehive, "Pose2Point2BearingRange", 0, M, seed=M))
    programs = list(convolve._PROGRAMS.values())
    assert sorted(p.out.shape[0] for p in programs) == [32, 48]
    assert programs[0] is not programs[1]


def test_the_engine_counters_count_calls_on_the_host(beehive):
    assert profiling.enabled()
    small = _message(beehive, "Pose2Pose2", 0, 16, seed=4)
    big = _message(beehive, "Pose2Pose2", 0, 24, seed=5)
    with profiling.annotate("test.root") as root:
        for args in (small, small, big, small):
            convolve.conv_particles(*args)
    assert root.attrs["np.gn_solves"] == 4
    assert root.attrs["np.gn_rows"] == 3 * 16 + 24
    assert root.attrs["np.gn_program.miss"] == 2
    assert root.attrs["np.gn_program.hit"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name,slot", CASES)
def test_the_captured_replay_is_its_eager_run_on_the_card(beehive, name, slot):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program is captured only on the card")
    M = 10_000
    first = _message(beehive, name, slot, M, seed=7, device="cuda")
    second = _message(beehive, name, slot, M, seed=8, device="cuda")
    got = convolve.conv_particles(*first)
    program = next(iter(convolve._PROGRAMS.values()))
    assert program.program.captured

    def eager(args):
        return program(*args[3:7], eager=True)

    assert torch.equal(got, eager(first))
    again = convolve.conv_particles(*second)
    assert torch.equal(again, eager(second))
    assert not torch.equal(got, again)
    assert torch.equal(got, convolve.conv_particles(*first))
    assert len(convolve._PROGRAMS) == 1
