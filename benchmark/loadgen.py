"""The load generator: a configuration's image pool and a traffic mix's calls.

A configuration file (configs/<name>.json) gives the encoder's settings and
the pool: "images", a list of {"h", "w", "count", "sigma_offset"} in the
order they are made, each image made by the frozen synth.synth_image with
the noise level noise_sigmas[(i + sigma_offset) % len(noise_sigmas)]. A
traffic file (traffic/<name>.json) gives the calls: "images_per_call"
("pool": every call encodes the whole pool, in a new order; or a number n:
the calls take n images at a time from the pool, shuffled anew each time it
is used up), "batch" ("config" or a number: encode_many_fast's batch),
"profile_calls" (the calls a traced run profiles) and "check_per_shape"
(distinct pool images of each shape that the correctness check decodes and
works out again). Everything is drawn from --seed: the same seed gives the
same pool and the same calls.
"""
import numpy as np

from benchmark import synth

CTU = 32


def make_pool(config, rng):
    """the configuration's images, made from rng, in the file's order."""
    sigmas = config["noise_sigmas"]
    pool = []
    for group in config["images"]:
        off = group.get("sigma_offset", 0)
        pool += [synth.synth_image(rng, group["h"], group["w"],
                                   sigmas[(i + off) % len(sigmas)])
                 for i in range(group["count"])]
    return pool


def fronts(h, w):
    """front steps of one slice of an h x w image: 2 (R - 1) + C."""
    R, C = -(-h // CTU), -(-w // CTU)
    return 2 * (R - 1) + C


def batches(shapes, batch):
    """[(h, w, B)] of the batches that encode_many_fast makes of images of
    these shapes: same-shaped images in groups of at most `batch`."""
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    out = []
    for (h, w), n in counts.items():
        out += [(h, w, min(batch, n - k)) for k in range(0, n, batch)]
    return out


class Load:
    """The pool and the calls of one cell, drawn from seed."""

    def __init__(self, config, traffic, seed: int):
        self.config, self.traffic = config, traffic
        self.rng = np.random.default_rng(seed)
        self.pool = make_pool(config, self.rng)
        b = traffic["batch"]
        self.batch = config["batch"] if b == "config" else int(b)
        self._order = []

    def next_call(self):
        """pool indices of the next call."""
        n = self.traffic["images_per_call"]
        if n == "pool":
            return [int(i) for i in self.rng.permutation(len(self.pool))]
        out = []
        for _ in range(int(n)):
            if not self._order:
                self._order = [int(i) for i in
                               self.rng.permutation(len(self.pool))]
            out.append(self._order.pop())
        return out

    def warmup_calls(self):
        """calls that build every batch shape the traffic makes: the whole
        pool once for pool calls; else one call of each shape."""
        if self.traffic["images_per_call"] == "pool":
            return [list(range(len(self.pool)))]
        n = int(self.traffic["images_per_call"])
        by_shape = {}
        for i, im in enumerate(self.pool):
            by_shape.setdefault(im.shape, []).append(i)
        return [idx[:n] for idx in by_shape.values()]

    def shape_batches(self, idx):
        """[(h, w, B)] of the batches of one call."""
        return batches([self.pool[i].shape for i in idx], self.batch)

    def fronts(self, idx):
        """front steps one call replays."""
        return sum(fronts(h, w) for h, w, _ in self.shape_batches(idx))

    def pixels(self, idx):
        """source pixels of one call (not padded to CTUs)."""
        return sum(int(self.pool[i].size) for i in idx)
