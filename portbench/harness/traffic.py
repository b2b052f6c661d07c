"""The one traffic generator: it reads a mix's parameters (``traffic/<mix>.json``)
and draws, from the run's seed, the id sequences.

Lengths follow the mix's law (a lognormal clipped to [min, max]) as a deck:
a fixed set of quantiles of the law, shuffled anew for each pass, so every
seed sends the same sizes in another order.  A batched mix draws its
batches the same way: a deck of text buckets in proportion to the law's
mass in each, then the batch's lengths from the law inside its bucket.
Ids are uniform over the voice's symbols past the pad symbol 0.
"""

import bisect
import math

import numpy as np


def lognormal_cdf(x, median, sigma):
    if x <= 0:
        return 0.0
    return 0.5 * (1.0 + math.erf(math.log(x / median) / (sigma * math.sqrt(2.0))))


def lognormal_ppf(p, median, sigma):
    """Inverse of :func:`lognormal_cdf` by bisection on the log scale."""
    lo, hi = math.log(median) - 12 * sigma, math.log(median) + 12 * sigma
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if lognormal_cdf(math.exp(mid), median, sigma) < p:
            lo = mid
        else:
            hi = mid
    return math.exp(0.5 * (lo + hi))


class Law:
    """A lognormal length law clipped to [min, max] ids."""

    def __init__(self, spec):
        self.median, self.sigma = float(spec["median"]), float(spec["sigma"])
        self.lo, self.hi = int(spec["min"]), int(spec["max"])

    def cdf(self, x):
        """P(length <= x) after clipping."""
        if x < self.lo:
            return 0.0
        if x >= self.hi:
            return 1.0
        return lognormal_cdf(x + 0.5, self.median, self.sigma)

    def quantile(self, p):
        return int(min(max(round(lognormal_ppf(p, self.median, self.sigma)), self.lo), self.hi))

    def draw_between(self, rng, a, b, size):
        """``size`` lengths from the law restricted to (a, b]."""
        pa, pb = self.cdf(a), self.cdf(b)
        u = pa + (pb - pa) * rng.random(size)
        return np.array([min(max(self.quantile(p), a + 1), b) for p in u], dtype=np.int64)


def bucket_shares(law, text_buckets):
    """{bucket: the law's mass in it} over the buckets the law reaches."""
    shares, prev = {}, 0
    for b in text_buckets:
        mass = law.cdf(b) - law.cdf(prev)
        if mass > 0:
            shares[b] = mass
        prev = b
    return shares


def deck_counts(shares, size):
    """Integer counts per key summing to ``size``, by largest remainder."""
    raw = {k: v * size / sum(shares.values()) for k, v in shares.items()}
    counts = {k: int(math.floor(v)) for k, v in raw.items()}
    short = size - sum(counts.values())
    for k in sorted(raw, key=lambda k: raw[k] - counts[k], reverse=True)[:short]:
        counts[k] += 1
    return {k: c for k, c in counts.items() if c}


class Traffic:
    """A mix's draws for one seed: ``batches()`` for a batched mix,
    ``sentences()`` one length at a time."""

    def __init__(self, mix, seed, num_symbols):
        self.mix = mix
        self.law = Law(mix["lengths"])
        seed = int(seed) & (2 ** 63 - 1)
        self.rng = np.random.default_rng([seed, 0])
        self._warm_rng = np.random.default_rng([seed, 1])
        self.num_symbols = num_symbols
        self.deck_size = int(mix.get("deck", 64))

    def ids(self, length, rng=None):
        rng = self.rng if rng is None else rng
        return rng.integers(1, self.num_symbols, size=int(length)).astype(np.int64)

    def sentences(self):
        """Endless id sequences, lengths from a shuffled deck of quantiles."""
        quantiles = [self.law.quantile((i + 0.5) / self.deck_size) for i in range(self.deck_size)]
        while True:
            for length in self.rng.permutation(quantiles):
                yield self.ids(length)

    def batches(self):
        """Endless batches of ``mix["batch"]`` id sequences of one text bucket.
        A deck of ``deck`` batches holds each bucket's share of them; the
        bucket's sentences take the law's quantiles inside it, dealt at
        random into its batches; the deck's batches go out in random order."""
        buckets, size = self.mix["buckets"]["text"], self.mix["batch"]
        counts = deck_counts(bucket_shares(self.law, buckets), self.deck_size)
        while True:
            deck = []
            for bucket, c in counts.items():
                i = bisect.bisect_left(buckets, bucket)
                prev = max(buckets[i - 1] if i > 0 else 0, self.law.lo - 1)
                top = min(int(bucket), self.law.hi)
                pa, pb = self.law.cdf(prev), self.law.cdf(top)
                n = c * size
                quantiles = [self.law.quantile(pa + (pb - pa) * (j + 0.5) / n) for j in range(n)]
                lengths = [min(max(q, prev + 1), top) for q in quantiles]
                lengths = list(self.rng.permutation(lengths))
                deck += [lengths[j * size : (j + 1) * size] for j in range(c)]
            for k in self.rng.permutation(len(deck)):
                yield [self.ids(n) for n in deck[k]]

    def warmup_batches(self):
        """Per text bucket the mix reaches, a batch at its shortest and one at
        its longest lengths: the shapes the window will meet."""
        buckets = self.mix["buckets"]["text"]
        out = []
        prev = 0
        for b in buckets:
            lo, hi = max(prev + 1, self.law.lo), min(b, self.law.hi)
            prev = b
            if lo > hi:
                continue
            for n in (lo, hi):
                out.append([self.ids(n, self._warm_rng) for _ in range(self.mix.get("batch", 1))])
        return out
