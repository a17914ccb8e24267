"""The port's wave-replay layer on the CPU (the kernel's plain version,
``wave_replay_plain``) against the JAX package's direct-conv oracle
``repro/kernels/wave_replay/ref.py::wave_replay_ref`` on the same numpy
inputs, on every body of the kernel: dense, grouped, depthwise with a
channel multiplier, residual, fused 3/2 pool, a ragged last tile, a
multi-step chain and a ragged batch. Tolerance: ``FP32_TOL`` (ref.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import decomposition as jdec  # noqa: E402
from repro.kernels.wave_replay.ref import \
    wave_replay_ref as jax_wave_replay_ref  # noqa: E402
from repro_torch.core import decomposition as tdec  # noqa: E402
from repro_torch.core.schedule import (DEFAULT_VMEM_BUDGET,  # noqa: E402
                                       compile_layer, lower_kernel_program,
                                       partition_waves)
from repro_torch.kernels.wave_replay import ops  # noqa: E402
from repro_torch.kernels.wave_replay.kernel import (  # noqa: E402
    launch_geometry, wave_replay_raw)
from repro_torch.kernels.wave_replay.ref import (fp32_error,  # noqa: E402
                                                 wave_replay_plain,
                                                 wave_replay_ref)

# name: (ConvLayer args, kwargs, plan (th, tw, fs, cs), lowering kwargs, batch)
CASES = {
    "dense": (("d", 12, 12, 8, 16, 3), dict(pad=1), (2, 2, 1, 1),
              dict(relu=True), 2),
    "grouped": (("g", 12, 11, 8, 12, 3), dict(pad=1, groups=2),
                (2, 1, 2, 1), dict(relu=True), 2),
    "depthwise_multiplier": (("dw", 10, 10, 6, 12, 3),
                             dict(stride=2, pad=1, groups=6), (1, 2, 1, 1),
                             dict(relu=True), 2),
    "residual": (("r", 9, 9, 8, 8, 3), dict(pad=1), (1, 1, 1, 2),
                 dict(relu=True, residual=True), 2),
    "pool": (("p", 23, 23, 3, 8, 5), dict(stride=2, pool=3, pool_stride=2),
             (2, 2, 1, 1), dict(relu=True, fuse_pool=True), 2),
    "ragged_tile": (("t", 13, 13, 4, 6, 3), dict(pad=1), (3, 3, 1, 1),
                    dict(), 1),
    "multi_chain": (("c", 10, 10, 16, 8, 3), dict(pad=1), (2, 1, 1, 4),
                    dict(relu=True, vmem_budget=None), 2),
    "ragged_batch": (("b", 8, 8, 6, 10, 3), dict(pad=1), (1, 1, 1, 2),
                     dict(relu=True, batch_block=2), 5),
}


def build(case):
    args, kw, plan, lower_kw, batch = CASES[case]
    jl, tl = jdec.ConvLayer(*args, **kw), tdec.ConvLayer(*args, **kw)
    lower_kw = dict(lower_kw)
    lower_kw.setdefault("vmem_budget", DEFAULT_VMEM_BUDGET)
    kp = lower_kernel_program(
        partition_waves(compile_layer(tl, tdec.evaluate(tl, *plan))),
        **lower_kw)
    rng = np.random.default_rng(sum(map(ord, case)))
    x = rng.standard_normal((batch, tl.in_h, tl.in_w, tl.in_c), np.float32)
    w = rng.standard_normal((tl.kernel, tl.kernel, tl.in_c // tl.groups,
                             tl.out_c), np.float32)
    b = rng.standard_normal((tl.out_c,), np.float32)
    r = rng.standard_normal((batch, tl.out_h, tl.out_w, tl.out_c),
                            np.float32) if kp.residual else None
    return jl, kp, x, w, b, r


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_layer_matches_jax_oracle(case):
    jl, kp, x, w, b, r = build(case)
    want = np.asarray(jax_wave_replay_ref(
        jl, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=kp.relu,
        fuse_pool=kp.fuse_pool,
        residual=None if r is None else jnp.asarray(r)))
    got = ops.wave_replay_layer(
        kp, torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
        residual=None if r is None else torch.as_tensor(r))
    assert got.shape == want.shape
    err, tol = fp32_error(got, want)
    assert err <= tol, (case, err, tol)
    # the port's own oracle is the same function
    mine = wave_replay_ref(
        kp.wave.program.layer, torch.as_tensor(x), torch.as_tensor(w),
        torch.as_tensor(b), relu=kp.relu, fuse_pool=kp.fuse_pool,
        residual=None if r is None else torch.as_tensor(r))
    err, tol = fp32_error(mine, want)
    assert err <= tol, (case, err, tol)


def test_cases_reach_every_body():
    """Each case exercises the program shape its name promises."""
    kps = {c: build(c)[1] for c in CASES}
    assert kps["dense"].groups == 1 and kps["dense"].n_tiles == 4
    assert kps["grouped"].groups == 2 and kps["grouped"].fan_width == 4
    dw = kps["depthwise_multiplier"]
    assert dw.groups == 6 and dw.fan_width == 1 and dw.out_c_pad == 12
    assert launch_geometry(dw, 1).depthwise == 1
    assert launch_geometry(kps["dense"], 1).depthwise == 0
    assert kps["residual"].residual and kps["residual"].n_chain == 1
    assert kps["residual"].chain_chunk == 2
    assert kps["pool"].fuse_pool and (kps["pool"].pool,
                                      kps["pool"].pool_stride) == (3, 2)
    assert kps["ragged_tile"].out_h_pad > kps["ragged_tile"].out_h
    assert kps["multi_chain"].n_chain == 4
    assert kps["ragged_batch"].batch_block == 2


def test_ragged_tile_masked_lanes_are_exact_zero():
    _, kp, x, w, b, _ = build("ragged_tile")
    xp, wp, bias = ops.pad_operands(kp, torch.as_tensor(x),
                                    torch.as_tensor(w), torch.as_tensor(b))
    table = torch.as_tensor(kp.operand_table())
    y = wave_replay_raw(kp, xp, wp, bias, table)
    assert y.shape == (1, kp.out_h_pad, kp.out_w_pad, kp.out_c_pad)
    assert torch.count_nonzero(y[:, kp.out_h:]) == 0
    assert torch.count_nonzero(y[:, :, kp.out_w:]) == 0
    assert torch.count_nonzero(y[:, :kp.out_h, :kp.out_w]) > 0


def test_ragged_batch_is_per_image():
    """A batch of 5 in blocks of 2 gives each image what it gets alone."""
    _, kp, x, w, b, _ = build("ragged_batch")
    xt, wt, bt = map(torch.as_tensor, (x, w, b))
    whole = ops.wave_replay_layer(kp, xt, wt, bt)
    for i in range(x.shape[0]):
        one = ops.wave_replay_layer(kp, xt[i:i + 1], wt, bt)
        err, tol = fp32_error(whole[i:i + 1], one)
        assert err <= tol


def test_launch_count_one_per_layer_call():
    _, kp, x, w, b, _ = build("dense")
    ops.reset_launch_count()
    for _ in range(3):
        ops.wave_replay_layer(kp, *map(torch.as_tensor, (x, w, b)))
    # CPU tensors run the plain version and launch no kernel
    assert ops.plain_count() == 3 and ops.launch_count() == 0
    ops.reset_launch_count()
    assert ops.plain_count() == 0


def test_raw_launcher_checks_operands():
    _, kp, x, w, b, _ = build("dense")
    xp, wp, bias = ops.pad_operands(kp, *map(torch.as_tensor, (x, w, b)))
    table = torch.as_tensor(kp.operand_table())
    with pytest.raises(ValueError, match="input"):
        wave_replay_raw(kp, xp[:, 1:], wp, bias, table)
    with pytest.raises(ValueError, match="int32"):
        wave_replay_raw(kp, xp, wp, bias, table.long())
    with pytest.raises(ValueError, match="float32"):
        wave_replay_raw(kp, xp.double(), wp, bias, table)
    with pytest.raises(ValueError, match="residual"):
        wave_replay_raw(kp, xp, wp, bias, table, residual=xp)
    # a tensor that is neither on the CPU nor on the card is refused
    with pytest.raises(ValueError, match="not meta"):
        wave_replay_raw(kp, *(t.to("meta") for t in (xp, wp, bias, table)))


def test_plain_version_is_the_launchers_cpu_route():
    _, kp, x, w, b, _ = build("pool")
    xp, wp, bias = ops.pad_operands(kp, *map(torch.as_tensor, (x, w, b)))
    table = torch.as_tensor(kp.operand_table())
    assert torch.equal(wave_replay_raw(kp, xp, wp, bias, table),
                       wave_replay_plain(kp, xp, wp, bias, table))
