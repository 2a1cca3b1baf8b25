"""The control at a size a test run can hold: the reference with its
contour moments accumulated in float32 instead of the float64 the port
states, put in the program's place, fails the cell's limits."""

import pytest


@pytest.mark.parametrize("cell", ["k08-revisit-10hz", "kaist-serve-b16"])
def test_control_fails_the_limits(spec, tiny, cell):
    import control
    nums = control.control_numbers(spec, cell, 31337, 0.5, "cpu", tiny[cell])
    limits = spec.limits(cell)
    fails = [k for k in ("mismatch", "corr_gap", "pose_gap", "desc_gap")
             if nums[k] > limits[k]]
    assert fails, nums


def test_witness_of_one_device_against_itself_reads_nothing(spec, tiny):
    """The CPU witness (the reference on the CPU against the reference on
    the card) compares the same items as a run: on a CPU-only machine
    both sides are the CPU and agree to the bit."""
    import control
    cell = "k08-revisit-10hz"
    nums = control.witness_numbers(spec, cell, 4711, 0.5, "cpu", tiny[cell],
                                   items=2, blocks=1)
    assert nums["answers"] == 2
    assert not any(nums["parts"].values()), nums["parts"]


def test_copy_store_copies_every_buffer(spec, tiny):
    import control
    from harness import check
    from plainref.query import PlainStore
    cfg = check.ref_config(spec.config("kitti08"))
    st = PlainStore(cfg, 4, "cpu")
    st.state[0] = 3
    cp = control.copy_store(st, "cpu")
    assert torch_equal(cp, st)
    cp.state[0] = 1
    assert int(st.state[0]) == 3


def torch_equal(a, b) -> bool:
    import torch
    return (all(torch.equal(x, y) for x, y in zip(a.store, b.store))
            and torch.equal(a.keys_q, b.keys_q)
            and torch.equal(a.ts_store, b.ts_store)
            and torch.equal(a.state, b.state))
