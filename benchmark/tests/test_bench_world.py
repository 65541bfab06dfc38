"""The benchmark's frozen generator against tools/gen_citygrid.py."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import world as W  # noqa: E402
from tools import gen_citygrid as G  # noqa: E402


@pytest.mark.parametrize("n, seed", [(10_000, 7), (3_500, 123456789012), (800, 3)])
def test_structure_is_the_generators(n, seed):
    poses, edges, n_lc = G.generate(n, seed)
    w = W.structure(n, seed)
    assert np.array_equal(w.poses, poses)
    assert np.array_equal(w.i, [e[0] for e in edges])
    assert np.array_equal(w.j, [e[1] for e in edges])
    assert int(w.closure.sum()) == n_lc
    # with the generator's own noise the means are its edges', bit for bit
    assert np.array_equal(W.measurements(w), np.stack([e[2] for e in edges]))
    info = np.array([[e[3], e[4]] for e in edges])
    assert np.allclose(w.sigmas[:, 0], 1 / np.sqrt(info[:, 0]))
    assert np.allclose(w.sigmas[:, 2], 1 / np.sqrt(info[:, 1]))


def test_noise_streams_share_one_connectivity():
    w = W.structure(600, 7)
    a = W.measurements(w, W.noise_seed(2**31 + 5, 0))
    b = W.measurements(w, W.noise_seed(2**31 + 5, 1))
    assert np.array_equal(a, W.measurements(w, W.noise_seed(2**31 + 5, 0)))
    assert not np.allclose(a, b)
    truth = W.se2_between(w.poses[w.i], w.poses[w.j])
    # each draw is the truth plus noise of the edge's stated deviation
    for z in (a, b):
        assert np.all(np.abs(z - truth) < 6 * w.sigmas)


def test_truncated_world_is_the_stream_prefix():
    w = W.structure(2_000, 7)
    t = w.truncated(1_200)
    assert t.n == 1_200 and np.all(np.maximum(t.i, t.j) < 1_200)
    keep = np.maximum(w.i, w.j) < 1_200
    assert np.array_equal(t.i, w.i[keep]) and np.array_equal(t.base_noise, w.base_noise[keep])
    # the odometry edges stay first and in order: row p - 1 is (p - 1, p)
    assert np.array_equal(t.j[: t.n - 1], np.arange(1, t.n))
