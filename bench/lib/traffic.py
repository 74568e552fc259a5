"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and makes the requests of a run.

Sizes repeat with the mix's ``period`` P: request i takes, in each
dimension (prompt, answer), the law's quantile at (j + 0.5) / P, where j
is the rank of frac(o_d + (i mod P) a_d) among the P points of the cycle
(a_d = phi^-d, the R2 sequence, phi the plastic number, the real root of
x^3 = x + 1).  So any P consecutive requests hold exactly the P
quantiles of each law, and in a low-discrepancy order; ``--seed`` sets
the offsets o_d (the order and the pairing of the dimensions) and the
token ids only.  Every seed offers the same sizes in another order, and
a window's percentiles do not hang on which sizes a seed drew.

Size laws: ``lognormal`` (median, sigma), ``uniform`` (min, max), each
clipped to [min, max]."""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np


PHI2 = 1.3247179572447460         # the real root of x^3 = x + 1
R2 = np.array([PHI2 ** -1, PHI2 ** -2])


def quantile(law: dict, u: np.ndarray) -> np.ndarray:
    """The law's sizes at quantiles u, clipped to [min, max], rounded."""
    if law["law"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        x = law["median"] * np.exp(law["sigma"] * z)
    elif law["law"] == "uniform":
        x = law["min"] + (law["max"] - law["min"]) * u
    else:
        raise ValueError(f"unknown size law {law['law']!r}")
    return np.clip(np.rint(x), law["min"], law["max"]).astype(np.int64)


def cycle(offsets: np.ndarray, period: int) -> np.ndarray:
    """[period, 2] quantile points: in each dimension, (j + 0.5) / period
    with j the rank of frac(o_d + k a_d) among k = 0 .. period - 1."""
    k = np.arange(period, dtype=np.float64)[:, None]
    u = np.mod(offsets[None, :] + k * R2[None, :], 1.0)
    ranks = np.argsort(np.argsort(u, axis=0, kind="stable"), axis=0,
                       kind="stable")
    return (ranks + 0.5) / period


@dataclasses.dataclass
class Request:
    index: int
    prompt: np.ndarray            # int32 token ids
    max_tokens: int


class ServeTraffic:
    """The requests of one run, in order."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), vocab
        self.points = cycle(np.random.default_rng([self.seed, 0]).random(2),
                            mix["period"])
        self.next = 0

    def sizes(self, start: int, n: int):
        """(prompt lengths, answer lengths) of requests start .. start +
        n - 1."""
        u = self.points[np.arange(start, start + n) % len(self.points)]
        return (quantile(self.mix["prompt"], u[:, 0]),
                quantile(self.mix["output"], u[:, 1]))

    @property
    def max_prompt(self) -> int:
        return self.mix["prompt"]["max"]

    @property
    def max_output(self) -> int:
        return self.mix["output"]["max"]

    def take(self) -> Request:
        """The next request: its sizes from the sequence, its own tokens
        from (seed, its index)."""
        i = self.next
        self.next += 1
        lens, out = self.sizes(i, 1)
        rng = np.random.default_rng([self.seed, 2, i])
        prompt = rng.integers(1, self.vocab, int(lens[0]))
        return Request(i, prompt.astype(np.int32), int(out[0]))


def bucket(n: int) -> int:
    """The engine's prompt bucket: the power of two >= max(n, 8)."""
    return max(8, 1 << max(0, math.ceil(math.log2(max(n, 1)))))
