"""The camera traffic generator: ``cameras`` streams, each capturing a frame
every 1/``fps`` seconds from a seeded offset inside the first period.

- ``"loop": "closed"``: a camera keeps at most one frame in flight. When
  its answer returns it hands over its newest frame, skipping those
  captured in between, as a video-analytics client does when it falls
  behind; if no new frame has been captured since the last one it sent, it
  waits for the next capture. A frame's latency runs from its handover.
- ``"loop": "open"``: every captured frame is handed over at its capture
  instant, whatever is in flight; its latency runs from that instant.

The cameras have captured for one period when the loop starts. A camera's
frames have one length, drawn from ``frame_tokens`` ([[tokens,
share], ...]) so that the shares hold over the cameras; a frame's token
ids come from the seed, the camera and the frame's capture index. Pure host
code: it holds no device state and tells the caller what to hand over
when.
"""
from __future__ import annotations

import math

import numpy as np


class Cameras:
    def __init__(self, traffic: dict, seed: int, vocab: int):
        n = int(traffic["cameras"])
        self.period = 1.0 / float(traffic["fps"])
        self.closed = traffic["loop"] == "closed"
        if traffic["loop"] not in ("closed", "open"):
            raise ValueError(f"loop {traffic['loop']!r}: closed or open")
        self.seed = seed % (1 << 63)
        self.vocab = vocab
        rng = np.random.default_rng([self.seed, 1])
        self.offsets = rng.uniform(0.0, self.period, n)
        self.lengths = _lengths(traffic["frame_tokens"], n, rng)
        self.sent = [-1] * n            # capture index of the newest frame sent
        self.busy = [False] * n         # a frame in flight (closed loop)
        self.t0 = 0.0

    def start(self, t: float) -> None:
        """Start the loop at ``t``. The cameras have been capturing for one
        period by then, so each has a frame to hand over at once: every
        seed starts from the same arrivals, and only the frames' offsets
        and contents differ."""
        self.t0 = t - self.period

    def capture_time(self, cam: int, k: int) -> float:
        return self.t0 + self.offsets[cam] + k * self.period

    def _newest(self, cam: int, now: float) -> int:
        """The capture index of the newest frame captured by ``now`` (-1:
        none yet)."""
        return math.floor((now - self.t0 - self.offsets[cam]) / self.period)

    def due(self, now: float) -> list:
        """The frames to hand over at ``now``: (camera, capture index, the
        instant the latency counts from), each marked sent."""
        out = []
        for cam in range(len(self.offsets)):
            if self.closed and self.busy[cam]:
                continue
            k = self._newest(cam, now)
            if k <= self.sent[cam]:
                continue
            if self.closed:
                out.append((cam, k, now))
                self.busy[cam] = True
            else:
                out.extend((cam, j, self.capture_time(cam, j))
                           for j in range(self.sent[cam] + 1, k + 1))
            self.sent[cam] = k
        return out

    def answered(self, cam: int) -> None:
        self.busy[cam] = False

    def next_capture(self) -> float:
        """The earliest instant a camera that may send will have a frame it
        has not sent."""
        return min((self.capture_time(c, self.sent[c] + 1)
                    for c in range(len(self.offsets))
                    if not (self.closed and self.busy[c])), default=math.inf)

    def tokens(self, cam: int, k: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 2, cam, k])
        return rng.integers(0, self.vocab, self.lengths[cam], dtype=np.int32)


def _lengths(shares: list, n: int, rng: np.random.Generator) -> list:
    """One frame length per camera: largest remainders over the shares, in
    an order drawn from the seed."""
    total = sum(s for _, s in shares)
    exact = [s / total * n for _, s in shares]
    counts = [math.floor(e) for e in exact]
    for i in sorted(range(len(shares)), key=lambda i: counts[i] - exact[i]
                    )[: n - sum(counts)]:
        counts[i] += 1
    lengths = [int(t) for (t, _), c in zip(shares, counts) for _ in range(c)]
    return [lengths[i] for i in rng.permutation(n)]
