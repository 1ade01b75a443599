"""The generator: deterministic by seed, the same work for every seed, and
a keyframe plus its region writes rebuild the client's frame exactly."""

import numpy as np

from portbench.reference.detect import rebuild
from portbench.traffic import Traffic, pool

MIX = {"streams": 5, "fps": 60, "frame": [600, 800], "keyframe_interval": 30,
       "roi_padding": 20, "rects": [1, 6], "speed_px": [1, 4],
       "pool_groups": 3, "scene_seed": 11, "ramp_s": 1.0, "sample": 8}


def test_same_seed_same_inputs_and_another_seed_others():
    a, b = Traffic(MIX, 2**31 + 77), Traffic(MIX, 2**31 + 77)
    c = Traffic(MIX, 2**31 + 78)
    assert np.array_equal(a.offsets, b.offsets)
    for ga, gb in zip(a.groups, b.groups):
        assert np.array_equal(ga.keyframe, gb.keyframe)
        assert len(ga.regions) == len(gb.regions) == 29
        for (xa, ya, pa), (xb, yb, pb) in zip(ga.regions, gb.regions):
            assert (xa, ya) == (xb, yb) and np.array_equal(pa, pb)
    assert not all(np.array_equal(ga.keyframe, gc.keyframe)
                   for ga, gc in zip(a.groups, c.groups))


def test_keyframe_and_regions_rebuild_every_captured_frame():
    checked = 0
    for seed in (5, 2**31 + 9):
        for group, frames in pool(MIX, seed):
            assert len(frames) == 30
            for k, frame in enumerate(frames):
                assert np.array_equal(
                    rebuild(group.keyframe, group.regions[:k]), frame)
            checked += 1
    assert checked == 6


def test_every_seed_writes_the_same_sizes():
    def sizes(t):
        return sorted(px.shape for g in t.groups for _, _, px in g.regions)
    a, b = Traffic(MIX, 1), Traffic(MIX, 2**32 + 5)
    assert sizes(a) == sizes(b)


def test_schedule_spreads_the_streams_over_a_frame_interval():
    t = Traffic(MIX, 9)
    dues = [t.due(e) for e in range(3 * MIX["streams"])]
    assert [d[:2] for d in dues[:6]] == [(0, 0), (1, 0), (2, 0), (3, 0),
                                         (4, 0), (0, 1)]
    gaps = np.diff([d[2] for d in dues])
    assert np.allclose(gaps, 1 / 60 / MIX["streams"])
    kind, _ = t.write(2, 30)
    assert kind == "key" and t.write(2, 31)[0] == "roi"
    kf, regions = t.history(2, 35)
    assert len(regions) == 5 and kf is t.write(2, 30)[1]
