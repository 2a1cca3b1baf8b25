"""The frozen bound arithmetic against PERF.md's kernel table and against
the port's own `kernel_times` bounds it was copied from."""

import pytest
import torch

from harness import roofline


def test_bytes_of_perf_md_kernel_table():
    # one scan's ring key: (36,8) anchors, (4096,8) pool, 35 centers
    n_ring = 4 * (36 * 8 + 4096 * 8 + 35) + 4 * 36 * 36
    assert n_ring == 137_548
    assert roofline.ring_us((1, 36, 8), (1, 4096, 8), 35, 0.0) == \
        pytest.approx(1e6 * 137_548 / roofline.HBM_BYTES_PER_S)
    # the tile-min fixture: bf16 (6, 10, 49152), 3 levels, 7000 searchable
    assert roofline.tilemin_us((6, 10, 49152), 2, (3, 6, 10), [7000]) == \
        pytest.approx(1e6 * 2_548_376 / roofline.HBM_BYTES_PER_S)
    # CC of one scan: (1, 6, 150, 150) masks
    assert roofline.cc_us(6 * 150 * 150) == \
        pytest.approx(1e6 * 675_000 / roofline.HBM_BYTES_PER_S)


def test_frozen_copies_equal_the_ports_bounds():
    from contour_context_tpu_torch import kernel_times as kt
    g = torch.Generator().manual_seed(0)
    sms, clk = roofline.SMS, roofline.MAX_SM_CLOCK_HZ
    anchors = torch.rand((16, 36, 8), generator=g)
    pool = torch.rand((16, 4096, 8), generator=g)
    centers = torch.rand((35,), generator=g)
    counts = torch.randint(0, 4000, (16, 36), generator=g).float()
    for cnt in (counts, counts * 0 + 1):
        want = kt.ring_bound(anchors, pool, centers, counts=cnt, sms=sms,
                             clk_hz=clk)[0]
        assert roofline.ring_us(tuple(anchors.shape), tuple(pool.shape), 35,
                                float(cnt.sum())) == pytest.approx(want)
    keys = torch.zeros((6, 10, 2048 * 6), dtype=torch.bfloat16)
    q = torch.zeros((3, 6, 10))
    state = torch.tensor([2100, 1900], dtype=torch.int32)
    assert roofline.tilemin_us(tuple(keys.shape), 2, (3, 6, 10), [1900]) == \
        pytest.approx(kt.tilemin_bound(keys, q, state)[0])
    sb = torch.tensor([2048] * 16, dtype=torch.int32)
    assert roofline.tilemin_us(tuple(keys.shape), 2, (3, 6, 10),
                               sb.tolist()) == pytest.approx(
        kt.tilemin_batch_bound(keys, torch.zeros((16, 3, 6, 10)), sb)[0])
    masks = torch.zeros((16, 6, 150, 150), dtype=torch.bool)
    assert roofline.cc_us(masks.numel()) == pytest.approx(
        kt.cc_bound(masks)[0])
    hint_of = torch.full((16, 64, 128), -1, dtype=torch.int32)
    hint_of[:, :10, :3] = torch.arange(3, dtype=torch.int32)
    hint_of[0, 0, :40] = 7
    T = torch.zeros((16, 128, 3))
    votes = torch.zeros((16, 128), dtype=torch.int32)
    lead = (hint_of >= 0).to(torch.int32).cumprod(-1).sum(-1)
    ids = int(torch.clamp(lead + 1, max=128).sum())
    hints = int((hint_of >= 0).sum())
    longest = int((hint_of >= 0).sum(-1).max())
    want = max(kt.merge_bound(hint_of, T, votes)[0],
               kt.merge_chain_bound(hint_of, clk))
    assert roofline.merge_us((16, 64, 128), ids, hints, longest) == \
        pytest.approx(want)


def test_the_reference_records_what_the_bound_needs():
    from plainref import kernels as rk
    rec = []
    masks = torch.zeros((2, 6, 20, 20), dtype=torch.bool)
    masks[:, :, 3:6, 3:6] = True
    with rk.recording(rec):
        rk.cc_labels(masks)
    rk.cc_labels(masks)                    # outside: not recorded
    assert rec == [("cc", {"masks": masks.numel()})]
    assert roofline.least_us(*rec[0]) == roofline.cc_us(masks.numel())
