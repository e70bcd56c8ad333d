"""The camera generator: the closed loop keeps one frame in flight per
camera and hands over the newest, skipping the rest; offsets and frames
come from the seed."""
import numpy as np

from harness.cameras import Cameras

TRAFFIC = {"cameras": 8, "fps": 2.0, "loop": "closed",
           "frame_tokens": [[576, 1.0]]}


def test_closed_loop_one_frame_in_flight_and_the_newest_sent():
    cams = Cameras(TRAFFIC, seed=7, vocab=100)
    cams.start(0.5)
    first = cams.due(0.5)                  # every camera has captured once
    assert sorted(c for c, _, _ in first) == list(range(8))
    assert all(k == 0 and t == 0.5 for _, k, t in first)
    assert cams.due(3.0) == []             # all in flight: nothing more
    cams.answered(3)
    (cam, k, t), = cams.due(3.0)
    # captures at offset + 0.5 k: by 3.0 the newest is k = 5; 1..4 skipped
    assert (cam, t) == (3, 3.0)
    assert k == int(np.floor((3.0 - cams.offsets[3]) / 0.5)) == 5
    cams.answered(3)
    assert cams.due(3.0) == []             # no frame newer than the last
    assert cams.next_capture() == cams.capture_time(3, 6)


def test_open_loop_hands_over_every_frame_at_its_capture():
    cams = Cameras(dict(TRAFFIC, loop="open"), seed=7, vocab=100)
    cams.start(10.5)
    got = cams.due(11.2)
    per_cam = {c: [k for cc, k, _ in got if cc == c] for c in range(8)}
    for c, ks in per_cam.items():
        assert ks == list(range(len(ks))) and len(ks) in (2, 3)
    assert all(t == cams.capture_time(c, k) for c, k, t in got)


def test_offsets_frames_and_lengths_come_from_the_seed():
    mixed = dict(TRAFFIC, frame_tokens=[[256, 1], [576, 2], [1024, 1]])
    a, b, c = (Cameras(mixed, s, 50_000) for s in (5, 5, 2**40 + 3))
    assert np.array_equal(a.offsets, b.offsets)
    assert not np.array_equal(a.offsets, c.offsets)
    assert all(0 <= o < 0.5 for o in c.offsets)
    assert np.array_equal(a.tokens(2, 9), b.tokens(2, 9))
    assert not np.array_equal(a.tokens(2, 9), a.tokens(2, 10))
    assert sorted(a.lengths) == [256, 256, 576, 576, 576, 576, 1024, 1024]
    assert a.lengths == b.lengths
    assert len(a.tokens(0, 0)) == a.lengths[0]
