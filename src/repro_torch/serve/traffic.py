"""Seeded synthetic heavy-traffic generator for the serving DLB lane
(the port's own numpy copy of ``repro.serve.traffic``: every draw is the
reference's, bit for bit).

Serving workloads are the second arena for the paper's loop (after PIC
boxes): per-expert load in an MoE server drifts on several timescales at
once, and a balancer can only be trusted if it was exercised against all
of them.  :class:`TrafficGenerator` produces that drift deterministically:

  * a **diurnal load curve** (:meth:`TrafficGenerator.load`) — a smooth
    day/night cycle of period ``period`` steps bounded below by
    ``night_load``; at night the topic mixture also flattens toward
    uniform (off-peak traffic is less opinionated);
  * a **skewed topic mixture** (:meth:`TrafficGenerator.topic_weights`) —
    Zipf-like weights over ``n_topics`` latent topics; each topic is a
    fixed random direction in ``d_model`` space, so a hot topic becomes a
    hot expert through the router;
  * **hot-topic flips** — every ``flip_every`` steps the Zipf ranking
    rotates by one, so yesterday's cold expert becomes today's hot one
    (the serving analogue of the laser ionization front sweeping across
    boxes);
  * **topic bursts** — in the first quarter of every ``burst_every``-step
    window one seeded topic's weight is multiplied by ``burst_gain`` (a
    viral prompt);
  * a **request-length mixture** (:meth:`TrafficGenerator.request_lengths`)
    — short interactive requests and long batch requests, Poisson arrivals
    thinned by the diurnal curve, folded into per-bucket costs for
    ``repro_torch.train.servestep.RequestBalancer`` by
    :meth:`TrafficGenerator.bucket_costs`.

Every sample is drawn from ``np.random.default_rng((seed, tag, step))`` —
a fresh generator keyed by the step and the quantity being drawn — so
traces are reproducible across runs, insensitive to call order, and
identical for every device count (no global RNG state anywhere).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict

import numpy as np

__all__ = ["TrafficConfig", "TrafficGenerator"]


def _rng(seed: int, tag: str, step: int) -> np.random.Generator:
    """Order-independent generator for one (quantity, step) draw."""
    return np.random.default_rng((seed, zlib.crc32(tag.encode("ascii")), step))


@dataclass(frozen=True)
class TrafficConfig:
    """Knobs of the synthetic serving trace (all drift is seeded).

    ``skew`` is the Zipf exponent of the topic mixture (0 = uniform
    traffic, larger = hotter hot topics).  ``flip_every`` rotates the hot
    topic (0 disables), ``burst_every``/``burst_gain`` shape the burst
    windows (0 disables), ``noise`` is the per-token isotropic noise
    around the topic direction.  ``request_rate``/``len_short``/
    ``len_long``/``long_frac`` shape the request-length mixture feeding
    the ``RequestBalancer`` buckets.
    """

    seed: int = 0
    d_model: int = 64
    batch: int = 4
    seq: int = 32
    n_topics: int = 8
    skew: float = 1.5
    period: int = 64
    night_load: float = 0.35
    flip_every: int = 0
    burst_every: int = 0
    burst_gain: float = 4.0
    noise: float = 0.15
    request_rate: float = 24.0
    len_short: int = 64
    len_long: int = 1024
    long_frac: float = 0.15


class TrafficGenerator:
    """Deterministic synthetic serving traffic (see module docstring).

    One instance per serving run; all methods are pure functions of
    ``(config, step)`` so two generators with equal configs agree on every
    step regardless of which steps each was asked about, in what order.
    """

    def __init__(self, cfg: TrafficConfig):
        if cfg.n_topics <= 0 or cfg.d_model <= 0:
            raise ValueError("n_topics and d_model must be positive")
        if not 0.0 < cfg.night_load <= 1.0:
            raise ValueError("night_load must be in (0, 1]")
        self.cfg = cfg
        # Fixed topic directions: the latent geometry of the traffic.
        g = _rng(cfg.seed, "topics", 0)
        vecs = g.standard_normal((cfg.n_topics, cfg.d_model))
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        self.topic_vecs = vecs.astype(np.float32)

    # -- drift processes ------------------------------------------------
    def load(self, step: int) -> float:
        """Diurnal load factor in ``[night_load, 1]`` at ``step`` (a raised
        sine of period ``period``; deterministic, no sampling)."""
        c = self.cfg
        phase = 0.5 * (1.0 + np.sin(2.0 * np.pi * step / max(c.period, 1)))
        return float(c.night_load + (1.0 - c.night_load) * phase)

    def topic_weights(self, step: int) -> np.ndarray:
        """Topic mixture at ``step``: Zipf ranks rotated by the hot-topic
        flip schedule, burst-boosted, then blended toward uniform by the
        (inverse) diurnal load — normalized, shape ``(n_topics,)``."""
        c = self.cfg
        ranks = np.arange(c.n_topics, dtype=np.float64)
        if c.flip_every > 0:
            ranks = np.roll(ranks, step // c.flip_every)
        w = (1.0 + ranks) ** (-c.skew)
        if c.burst_every > 0 and step % c.burst_every < max(c.burst_every // 4, 1):
            window = step // c.burst_every
            topic = int(_rng(c.seed, "burst", window).integers(c.n_topics))
            w = w.copy()
            w[topic] *= c.burst_gain
        w /= w.sum()
        load = self.load(step)
        uniform = np.full(c.n_topics, 1.0 / c.n_topics)
        w = load * w + (1.0 - load) * uniform
        return w / w.sum()

    def hot_topic(self, step: int) -> int:
        """Index of the heaviest topic at ``step`` (trace diagnostic)."""
        return int(np.argmax(self.topic_weights(step)))

    # -- token-level traffic (feeds the MoE router) ---------------------
    def batch(self, step: int) -> np.ndarray:
        """One serving batch at ``step``: tokens drawn as (topic direction
        + isotropic noise), shape ``(batch, seq, d_model)`` float32.  The
        shape is fixed — a saturated server — so the served step's shapes never change;
        the *mixture* under the fixed shape is what drifts."""
        c = self.cfg
        g = _rng(c.seed, "batch", step)
        topics = g.choice(c.n_topics, size=(c.batch, c.seq), p=self.topic_weights(step))
        x = self.topic_vecs[topics] + c.noise * g.standard_normal(
            (c.batch, c.seq, c.d_model)
        ).astype(np.float32)
        return x.astype(np.float32)

    # -- request-level traffic (feeds the RequestBalancer buckets) ------
    def request_lengths(self, step: int) -> np.ndarray:
        """Lengths of the requests arriving at ``step``: Poisson arrivals
        (rate thinned by the diurnal load) with a short/long mixture —
        short interactive requests near ``len_short``, long batch requests
        near ``len_long``.  At least one request always arrives."""
        c = self.cfg
        g = _rng(c.seed, "requests", step)
        n = max(1, int(g.poisson(c.request_rate * self.load(step))))
        long_mask = g.random(n) < c.long_frac
        short = g.integers(1, c.len_short + 1, size=n)
        long = g.integers(c.len_short + 1, c.len_long + 1, size=n)
        return np.where(long_mask, long, short).astype(np.int64)

    def bucket_costs(self, step: int, n_buckets: int) -> np.ndarray:
        """Fold ``step``'s arrivals into ``n_buckets`` per-bucket costs
        (summed request lengths): requests are sorted longest-first and
        split contiguously, so buckets are as unequal as the length
        mixture makes them — the skew the balancer must erase."""
        if n_buckets <= 0:
            raise ValueError("n_buckets must be positive")
        lengths = np.sort(self.request_lengths(step))[::-1]
        chunks = np.array_split(lengths.astype(np.float64), n_buckets)
        return np.array([chunk.sum() for chunk in chunks], np.float64)

    # -- whole-trace view ----------------------------------------------
    def trace(self, n_steps: int) -> Dict[str, np.ndarray]:
        """Summary trace over ``steps 0..n_steps-1`` — per-step diurnal
        load, hot topic, arrival count and total requested tokens — used
        by the determinism tests and the benchmark narrative."""
        load = np.array([self.load(s) for s in range(n_steps)])
        hot = np.array([self.hot_topic(s) for s in range(n_steps)])
        lengths = [self.request_lengths(s) for s in range(n_steps)]
        return {
            "load": load,
            "hot_topic": hot,
            "n_requests": np.array([len(l) for l in lengths]),
            "requested_tokens": np.array([int(l.sum()) for l in lengths]),
        }
