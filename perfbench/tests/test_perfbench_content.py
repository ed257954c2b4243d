"""The frozen content generator: one seed gives the same frames bit for
bit, two seeds differ, and every seed cuts at the same frames with the
same set of motions."""

import numpy as np
import pytest

from perfbench import content

TRAFFIC = dict(pool_frames=24, shot_frames=[10, 8], segment_frames=None,
               pan_px=[0, 8], objects=[2, 6], object_px=[0, 16], noise=2)


def frames_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x, y) for fa, fb in zip(a, b) for x, y in zip(fa, fb))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_same_seed_same_frames(seed):
    a = content.generate(TRAFFIC, 96, 64, seed)
    b = content.generate(TRAFFIC, 96, 64, seed)
    assert frames_equal(a, b)
    assert len(a) == 24
    y, u, v = a[0]
    assert y.shape == (64, 96) and u.shape == (32, 48) and v.shape == u.shape
    assert y.dtype == np.uint8


def test_seeds_differ():
    a = content.generate(TRAFFIC, 96, 64, 1)
    b = content.generate(TRAFFIC, 96, 64, 2)
    assert not any(np.array_equal(x[0], y[0]) for x, y in zip(a, b))


def test_frames_change_every_frame():
    a = content.generate(TRAFFIC, 96, 64, 3)
    assert all(not np.array_equal(a[i][0], a[i + 1][0]) for i in range(23))


def test_cuts_and_motions_do_not_depend_on_the_seed():
    plans = [content.plan(TRAFFIC, 96, 64, s) for s in (1, 2, 2 ** 33)]
    assert [s.start for s in plans[0]] == [0, 10, 18]
    for p in plans[1:]:
        assert [s.start for s in p] == [s.start for s in plans[0]]
        speeds = sorted(round(np.hypot(*seg[1]), 9) for s in p
                        for seg in s.segments)
        assert speeds == sorted(round(np.hypot(*seg[1]), 9)
                                for s in plans[0] for seg in s.segments)
        assert sorted(len(s.objects) for s in p) == sorted(
            len(s.objects) for s in plans[0])
    assert content.cut_frames(TRAFFIC, 96, 64, 5) == [10, 18]


def test_one_shot_with_segments():
    t = dict(TRAFFIC, shot_frames=None, segment_frames=6)
    shots = content.plan(t, 96, 64, 4)
    assert len(shots) == 1 and len(shots[0].segments) == 4
    assert content.cut_frames(t, 96, 64, 4) == []
