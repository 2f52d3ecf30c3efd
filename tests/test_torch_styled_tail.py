"""The styled conv's tail (ops/styled_tail, csrc/styled_tail.cu) on the CPU:
the launch plan at MaterialGAN's shapes, and the kernels' own device code
built for the host (utils/host_styled_tail: a block's threads as threads,
its barriers and warp shuffles emulated) held to the plain version by the
card suite's rule (bench_setup.hold_styled_tail_kernels), on the plans of
an H100 (132 SMs) and of a 2-SM card (which splits the channels into
groups of one), on ragged shapes, with NaN inputs, and to the bit from run
to run. The card holds the card's build (tests/test_torch_card.py).
"""

import pytest
import torch

from svbrdf_tpu_torch.ops import styled_tail as st
from svbrdf_tpu_torch.utils import bench_setup
from svbrdf_tpu_torch.utils import host_styled_tail as host

torch.set_num_threads(1)

# (B, C, H, W, up): a plain and an up conv of the generator's smallest
# levels, ragged sizes, one pixel, more channels than a group holds.
CASES = [(2, 5, 4, 4, False), (2, 6, 8, 8, True), (1, 3, 5, 7, True),
         (2, 4, 33, 40, True), (2, 3, 33, 40, False), (1, 2, 64, 64, True),
         (3, 70, 4, 4, False), (2, 40, 16, 16, True), (1, 2, 100, 3, True),
         (1, 1, 1, 1, True), (2, 3, 2, 1, False)]


def _host(sms):
    return (lambda *a: host.forward(*a, sms=sms),
            lambda *a: host.backward(*a, sms=sms))


def test_the_plan_at_the_capture_shapes():
    """Every tail of the config-f generator at batch 8 on an H100: tiles of
    at most 1024 pixels and 4 a thread, whole warps, and at least four
    blocks an SM."""
    for case in bench_setup.styled_tail_cases(8):
        b, c, h, w, _ = case
        p = st.plan(b, c, h, w, host.H100_SMS)
        assert p.th * p.tw <= st.MAX_TILE
        assert p.threads % 32 == 0 and p.threads <= st.MAX_THREADS
        assert p.th * p.tw <= 4 * p.threads
        assert b * p.tiles * p.groups >= st.BLOCKS_PER_SM * host.H100_SMS
        assert p.tiles == -(-h // p.th) * -(-w // p.tw)
        assert p.groups == -(-c // p.cg)
    assert st.plan(8, 128, 256, 256, 132) == st.Plan(32, 32, 32, 256, 64, 4)
    assert st.plan(8, 512, 4, 4, 132) == st.Plan(4, 4, 4, 32, 1, 128)
    assert [c[1:] for c in bench_setup.styled_tail_cases(8)][:3] == [
        (512, 4, 4, False), (512, 8, 8, True), (512, 8, 8, False)]
    assert len(bench_setup.styled_tail_cases(8)) == 13


@pytest.mark.parametrize("sms", [host.H100_SMS, 2])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_host_build_matches_plain(case, sms):
    held = bench_setup.hold_styled_tail_kernels(case, 1, "cpu", *_host(sms))
    assert held["failed"] == [], held


@pytest.mark.parametrize("case", [(1, 6, 64, 64, True), (2, 8, 16, 16, False),
                                  (1, 3, 40, 33, True)], ids=str)
@pytest.mark.parametrize("where", ["t", "g"])
def test_host_build_propagates_nan_as_the_plain_version(case, where):
    """A NaN in t or in the cotangent: every result NaN exactly where the
    plain version's is (a NaN pre-activation takes leaky ReLU's 0.2 side in
    the backward, as torch's does)."""
    x = bench_setup.styled_tail_inputs(case, 3, "cpu")
    x[where][0, 1, 5, 7] = float("nan")
    got = bench_setup.styled_tail_kernels(x, case[4], *_host(2))
    want = bench_setup.styled_tail_reference(x, case[4])
    nan = {"t": ("out", "grad_d"),
           "g": ("grad_t", "grad_d", "grad_bias", "grad_noise",
                 "grad_strength")}[where]
    for name, r in want.items():
        assert torch.equal(torch.isnan(got[name]), torch.isnan(r)), name
        assert bool(torch.isnan(r).any()) == (name in nan), name


def test_host_build_repeats_to_the_bit_and_honours_what_is_wanted():
    """The sums that cross blocks go through partials in a fixed order: two
    runs agree to the bit; a backward that wants only some gradients gives
    those, the same, and None for the rest."""
    case = (2, 6, 64, 64, True)
    x = bench_setup.styled_tail_inputs(case, 4, "cpu")
    args = [x[k] for k in ("t", "d", "bias", "noise", "strength")]
    out, y = host.forward(*args, True, True, sms=2)
    assert y is not None and host.forward(*args, True, sms=2)[1] is None
    first = host.backward(x["g"], y, *args[1:], True, sms=2)
    again = host.backward(x["g"], y, *args[1:], True, sms=2)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    for wants in [(True, False, False, False, False),
                  (False, True, False, False, False),
                  (False, False, True, False, False),
                  (False, False, False, True, False),
                  (False, False, False, False, True),
                  (False, True, True, True, False),
                  (True, False, True, False, True)]:
        got = host.backward(x["g"], y, *args[1:], True, wants, sms=2)
        for want, a, b in zip(wants, got, first):
            assert (a is None) != want and (a is None or torch.equal(a, b))
    plain = x["t"][:, :, :64, :64].contiguous()
    out, kept = host.forward(plain, *args[1:], False, True)
    assert kept is plain


@pytest.mark.parametrize("kink", [bench_setup.STYLED_TAIL_KINK, 0.3])
def test_the_inputs_keep_the_cotangent_off_the_kink(monkeypatch, kink):
    """styled_tail_inputs zeroes the cotangent exactly where the float64
    pre-activation lies within STYLED_TAIL_KINK of 0, plain and up (at a
    margin of 0.3 a good share of the points)."""
    monkeypatch.setattr(bench_setup, "STYLED_TAIL_KINK", kink)
    for case in [(2, 6, 8, 8, True), (2, 6, 8, 8, False)]:
        x = bench_setup.styled_tail_inputs(case, 2, "cpu")
        y = x["t"].double()
        if case[4]:
            y = st.blur(y, st.fir_kernel(dtype=torch.float64))
        pre = (x["bias"].double()[:, None, None]
               + y * x["d"].double()[:, :, None, None]
               + x["noise"].double() * x["strength"].double())
        near = pre.abs() < kink
        assert torch.equal(x["g"] == 0, near)
        assert bool(near.any()) == (kink == 0.3)


def test_the_wrappers_refuse_cpu_tensors():
    x = bench_setup.styled_tail_inputs((1, 2, 4, 4, False), 0, "cpu")
    args = [x[k] for k in ("t", "d", "bias", "noise", "strength")]
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        st.styled_tail_fwd_cuda(*args, False)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        st.styled_tail_bwd_cuda(x["g"], *args, False)
    # The op itself takes the plain version on the CPU.
    assert torch.equal(st.styled_tail(*args),
                       st.styled_tail_plain(*args))


@pytest.mark.parametrize("wants", [(True,) * 5, (True, True, False, True,
                                                False),
                                   (False, False, True, False, True)],
                         ids=str)
def test_the_backward_takes_scratch_floats_and_refuses_fewer(monkeypatch,
                                                             wants):
    """scratch_floats is the C entry's layout: on a plan with several tiles
    and channel groups the host build runs with that many floats and
    refuses one fewer."""
    case = (1, 6, 64, 64, True)
    p = st.plan(*case[:4], 2)
    assert p.tiles > 1 and p.groups > 1
    x = bench_setup.styled_tail_inputs(case, 1, "cpu")
    args = [x[k] for k in ("t", "d", "bias", "noise", "strength")]
    _, y = host.forward(*args, True, True, sms=2)
    grads = host.backward(x["g"], y, *args[1:], True, wants, sms=2)
    assert [g is not None for g in grads] == list(wants)
    n = st.scratch_floats(p, *case[:4], wants)
    monkeypatch.setattr(st, "scratch_floats", lambda *a: n - 1)
    with pytest.raises(RuntimeError, match="backward kernel launch failed"):
        host.backward(x["g"], y, *args[1:], True, wants, sms=2)
