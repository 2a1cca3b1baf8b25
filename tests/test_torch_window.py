"""The port's temporal window (`db.update_window`, `db.replay_window`)
against tests/test_window_stagger.py's two models of it, on the same long
synthetic traces (10 Hz, KITTI's rate; 1 Hz, the synthetic benchmark's):

- driven once a scan (the scan appended, then its push), the port's pop
  times equal that file's numpy twin `_repo_pop_times` exactly, with the
  timestamps in float64 (the twin's) and in float32 (what the DB's
  `ts_store` holds, the twin fed the same float32 values); replayed in
  blocks of 16 (`replay_window`, as a block step runs it) they are the same;
- against the reference's bucket-wave schedule (`oracle.RefLayerDB`), the
  three bounds that file holds the JAX package's window to: no key is
  searchable before min_elapse, every key is searchable once older than
  max_elapse plus one wave period, and the searchability onsets of the two
  models differ by at most the (max_elapse - min_elapse) trigger band plus
  one wave period.
"""

import numpy as np
import pytest
import torch

from test_window_stagger import (MAX_ELAPSE, MIN_ELAPSE, WAVE_PERIOD,
                                 _drive, _key_trace, _repo_pop_times)

from contour_context_tpu_torch import db as tdb

RATES = {"10hz": (2000, 0.1, 0), "1hz": (400, 1.0, 1)}


def _port_pop_times(ts: np.ndarray, block: int = 1) -> np.ndarray:
    """The scan at which each scan's rows became searchable (-1: never)
    under the port's window, one push a scan in scan order; with block > 1
    each block of scans is appended first and its pushes replayed."""
    n = len(ts)
    dt = torch.float64 if ts.dtype == np.float64 else torch.float32
    ts_store = torch.from_numpy(ts.copy()).to(dt)
    state = torch.zeros(2, dtype=torch.int32)
    pop = np.full(n, -1, np.int64)
    for s in range(0, n, block):
        e = min(s + block, n)
        if block == 1:
            state[0] = e
            prev = int(state[1])
            tdb.update_window(state, ts_store, ts_store[s], MIN_ELAPSE,
                              MAX_ELAPSE)
            pop[prev:int(state[1])] = s
            continue
        state[0] = e
        before = int(state[1])
        sb = tdb.replay_window(state, ts_store, ts_store[s:e], MIN_ELAPSE,
                               MAX_ELAPSE).tolist() + [int(state[1])]
        # query b of the block saw sb[b]; the push of scan s+b set sb[b+1]
        prev = before
        for b in range(e - s):
            pop[prev:sb[b + 1]] = s + b
            prev = max(prev, sb[b + 1])
    return pop


def _trace(rate):
    n, dt, seed = RATES[rate]
    return np.arange(n) * dt, dt, seed


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rate", sorted(RATES))
def test_pop_times_equal_the_numpy_twin(rate, dtype):
    ts, _, _ = _trace(rate)
    ts = ts.astype(dtype)
    want = _repo_pop_times(ts)
    got = _port_pop_times(ts)
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() > 0.8 * len(ts)


@pytest.mark.parametrize("rate", sorted(RATES))
def test_block_replay_gives_the_same_pop_times(rate):
    """A block's rows are appended before its pushes, but a push counts
    only rows older than min_elapse, so the replay pops what the per-scan
    order pops, when it pops it."""
    ts, _, _ = _trace(rate)
    ts = ts.astype(np.float32)
    np.testing.assert_array_equal(_port_pop_times(ts, block=16),
                                  _port_pop_times(ts))


@pytest.mark.parametrize("rate", sorted(RATES))
def test_onsets_within_the_reference_schedule_bounds(rate):
    ts, dt, seed = _trace(rate)
    rng = np.random.default_rng(seed)
    keys = _key_trace(rng, len(ts))
    ref_pop, _ = _drive(ts, keys)
    port_pop = _port_pop_times(ts.astype(np.float32))
    late = MAX_ELAPSE + (WAVE_PERIOD + 1) * dt
    band = int((MAX_ELAPSE - MIN_ELAPSE) / dt) + WAVE_PERIOD
    max_delay = n_compared = 0
    for (lv, i, seq), ref_at in ref_pop.items():
        assert MIN_ELAPSE - dt <= ts[ref_at] - ts[i] <= late, (i, ref_at)
        if port_pop[i] >= 0:
            n_compared += 1
            max_delay = max(max_delay, abs(int(ref_at) - int(port_pop[i])))
    assert n_compared > 0.8 * len(ref_pop)
    assert max_delay <= band, max_delay
    for i in range(len(ts)):
        if port_pop[i] >= 0:
            # the min_elapse exclusion, and searchable by max_elapse + wave
            assert MIN_ELAPSE - dt <= ts[port_pop[i]] - ts[i] <= late, i
        else:
            assert ts[-1] - ts[i] <= late, i
