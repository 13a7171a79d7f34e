"""The lockstep engine's tracing on the CPU: with a caller's PhaseTimer the
host's wait for the card is a card_wait phase inside writeback and
winner_fetch, every fetch event counts its mode (fetch_winner, fetch_full,
fetch_none), the CPU adds no card time (tracing.CARD), and the streams are
the same with and without a timer. The card's CARD total is held in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from hevce_tpu_torch.parallel import lockstep
from hevce_tpu_torch.utils.tracing import CARD, PhaseTimer

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

NODE_PER_CTU, PU_PER_CTU = 21, 64


def _images():
    rng = np.random.default_rng(29)
    return [rng.integers(0, 256, (32, 32)).astype(np.uint8),
            np.full((32, 32), 77, np.uint8)]


@pytest.fixture(scope="module")
def runs():
    """(streams and recons without a timer, with one, the timer)."""
    imgs = _images()
    plain = lockstep.encode_batch(imgs, 2, device="cpu")
    timer = PhaseTimer(spans=[])
    timed = lockstep.encode_batch(imgs, 2, timer=timer, device="cpu")
    return plain, timed, timer


def test_streams_unchanged_with_a_timer(runs):
    (plain, plain_rc), (streams, rcons), _ = runs
    assert streams == plain
    for a, b in zip(rcons, plain_rc):
        np.testing.assert_array_equal(a, b)


def test_card_wait_inside_writeback_and_winner_fetch(runs):
    timer = runs[2]
    spans = timer.spans
    waits = [s for s in spans if s[0] == "card_wait"]
    assert waits and len(waits) == timer.counts["card_wait"]
    for _, t0, t1, parent, _ in waits:
        name, p0, p1, _, _ = spans[parent]
        assert name in ("writeback", "winner_fetch")
        assert p0 <= t0 <= t1 <= p1
    self_times = timer.self_times()
    for phase in ("writeback", "winner_fetch"):
        assert 0 <= self_times[phase] <= timer.totals[phase]


def test_fetch_counts_add_up_to_the_fetch_events(runs):
    timer = runs[2]
    # one fetch event after each node and PU event, each counted once by
    # its mode
    events = NODE_PER_CTU + PU_PER_CTU
    fetches = [timer.counts[f"fetch_{m}"] for m in ("winner", "full",
                                                    "none")]
    assert sum(fetches) == events
    assert timer.counts["writeback"] == events
    # a fetch event opens winner_fetch at its dispatch and its completion
    assert timer.counts["winner_fetch"] == 2 * sum(fetches)
    # the card_wait of every writeback, winner gather and full fetch
    assert timer.counts["card_wait"] == events + fetches[0] + fetches[1]


def test_no_card_total_on_the_cpu(runs):
    timer = runs[2]
    assert CARD not in timer.totals and CARD not in timer.counts
