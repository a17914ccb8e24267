"""The port's int8 wave-replay layer on the CPU (the K3 kernel's plain
version, ``wave_replay_q_plain``, through the ops wrapper) against the
JAX package's int32 oracle ``repro/kernels/wave_replay_q/ref.py::
quant_layer_ref`` on the same numpy inputs, ``array_equal`` on every
body: dense, grouped, fused 3/2 pool, residual, depthwise with and
without a channel multiplier, a ragged masked tile grid, a multi-step
chain and a ragged batch. Plus the launcher's checks and counters."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import decomposition as jdec  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.kernels.wave_replay_q.ref import \
    quant_layer_ref as jax_quant_layer_ref  # noqa: E402
from repro.kernels.wave_replay_q.ref import \
    quant_layer_ref_from_quant as jax_ref_from_quant  # noqa: E402
from repro.quant.calibrate import quantize_layer as jax_quantize_layer  # noqa: E402,E501
from repro_torch.core import decomposition as tdec  # noqa: E402
from repro_torch.core.schedule import (DEFAULT_VMEM_BUDGET,  # noqa: E402
                                       compile_layer, lower_kernel_program,
                                       partition_waves)
from repro_torch.kernels.wave_replay.kernel import launch_geometry  # noqa: E402,E501
from repro_torch.kernels.wave_replay_q import ops  # noqa: E402
from repro_torch.kernels.wave_replay_q.kernel import (  # noqa: E402
    _vec_words, q_weight_fan, wave_replay_q_raw)
from repro_torch.kernels.wave_replay_q.ref import (  # noqa: E402
    quant_layer_ref, wave_replay_q_plain)
from repro_torch.quant.calibrate import quantize_layer  # noqa: E402

# name: (ConvLayer args, kwargs, plan (th, tw, fs, cs), lowering kwargs, batch)
CASES = {
    "dense": (("d", 12, 12, 8, 16, 3), dict(pad=1), (2, 2, 1, 1),
              dict(relu=True), 2),
    "grouped": (("g", 12, 11, 8, 12, 3), dict(pad=1, groups=2),
                (2, 1, 2, 1), dict(relu=True), 2),
    "depthwise": (("dw1", 9, 9, 8, 8, 3), dict(pad=1, groups=8),
                  (1, 1, 1, 1), dict(relu=True), 2),
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
    """(jax layer, program, numpy int8/int32 operands) for one case; the
    requantize scale is set so outputs spread over the int8 range."""
    args, kw, plan, lower_kw, batch = CASES[case]
    jl, tl = jdec.ConvLayer(*args, **kw), tdec.ConvLayer(*args, **kw)
    lower_kw = dict(lower_kw)
    lower_kw.setdefault("vmem_budget", DEFAULT_VMEM_BUDGET)
    kp = lower_kernel_program(
        partition_waves(compile_layer(tl, tdec.evaluate(tl, *plan))),
        **lower_kw)
    rng = np.random.default_rng(sum(map(ord, case)))
    fan = tl.kernel ** 2 * (tl.in_c // tl.groups)

    def i8(shape):
        return rng.integers(-127, 128, shape).astype(np.int8)

    xq = i8((batch, tl.in_h, tl.in_w, tl.in_c))
    wq = i8((tl.kernel, tl.kernel, tl.in_c // tl.groups, tl.out_c))
    bq = rng.integers(-3000, 3000, tl.out_c).astype(np.int32)
    ratio = rng.uniform(0.5, 2.0, tl.out_c) * 60 / (np.sqrt(fan) * 5376)
    m, shift, pre = jq.requant_params(ratio, fan * 127 * 127 + 3000)
    r = i8((batch, kp.out_h, kp.out_w, tl.out_c)) if kp.residual else None
    return jl, kp, dict(xq=xq, wq=wq, bq=bq, m=m, shift=shift, pre=pre, r=r)


def jax_oracle(jl, kp, o):
    return np.asarray(jax_quant_layer_ref(
        jl, *(jnp.asarray(o[k]) for k in ("xq", "wq", "bq", "m", "shift")),
        pre_shift=o["pre"], relu=kp.relu, fuse_pool=kp.fuse_pool,
        residual=None if o["r"] is None else jnp.asarray(o["r"])))


def port_layer(kp, o, **kw):
    t = {k: None if v is None else torch.as_tensor(v)
         for k, v in o.items() if k != "pre"}
    return ops.wave_replay_q_layer(kp, t["xq"], t["wq"], t["bq"], t["m"],
                                   t["shift"], pre_shift=o["pre"],
                                   residual=t["r"], **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_layer_bit_exact_to_jax_int32_oracle(case):
    jl, kp, o = build(case)
    want = jax_oracle(jl, kp, o)
    got = port_layer(kp, o)
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).mean() > 0.2                  # a non-trivial output
    # the port's own oracle is the same function
    mine = quant_layer_ref(
        kp.wave.program.layer,
        *(torch.as_tensor(o[k]) for k in ("xq", "wq", "bq", "m", "shift")),
        pre_shift=o["pre"], relu=kp.relu, fuse_pool=kp.fuse_pool,
        residual=None if o["r"] is None else torch.as_tensor(o["r"]))
    np.testing.assert_array_equal(mine.numpy(), want)


def test_cases_reach_every_body():
    """Each case exercises the program shape its name promises."""
    kps = {c: build(c)[1] for c in CASES}
    assert kps["dense"].groups == 1 and kps["dense"].n_tiles == 4
    assert kps["grouped"].groups == 2 and kps["grouped"].fan_width == 4
    assert launch_geometry(kps["depthwise"], 1).depthwise == 1
    assert kps["depthwise"].out_c_pad // kps["depthwise"].groups == 1
    dw = kps["depthwise_multiplier"]
    assert launch_geometry(dw, 1).depthwise == 1 and dw.out_c_pad == 12
    assert kps["residual"].residual and kps["residual"].n_chain == 1
    assert kps["pool"].fuse_pool and (kps["pool"].pool,
                                      kps["pool"].pool_stride) == (3, 2)
    assert kps["ragged_tile"].out_h_pad > kps["ragged_tile"].out_h
    assert kps["multi_chain"].n_chain == 4
    assert kps["ragged_batch"].batch_block == 2
    assert all(q_weight_fan(kp) == kp.fan_width for kp in kps.values())
    # both of the kernel's A-operand loads are reached
    assert _vec_words(kps["dense"]) and not _vec_words(kps["pool"])


def test_masked_lanes_and_pad_channels_are_exact_zero():
    _, kp, o = build("ragged_tile")
    xp, wp, bqp, mp, sp = ops.pad_operands_q(
        kp, *(torch.as_tensor(o[k]) for k in ("xq", "wq", "bq", "m",
                                               "shift")))
    assert (sp[0, kp.wave.program.layer.out_c:] == 31).all()
    table = torch.as_tensor(kp.operand_table())
    y = wave_replay_q_raw(kp, xp, wp, bqp, mp, sp, table,
                          pre_shift=o["pre"])
    assert y.shape == (1, kp.out_h_pad, kp.out_w_pad, kp.out_c_pad)
    assert torch.count_nonzero(y[:, kp.out_h:]) == 0
    assert torch.count_nonzero(y[:, :, kp.out_w:]) == 0
    assert torch.count_nonzero(y[..., kp.wave.program.layer.out_c:]) == 0
    assert torch.count_nonzero(y[:, :kp.out_h, :kp.out_w]) > 0
    # a bias that alone would saturate leaves the pad channels at zero
    y = wave_replay_q_raw(kp, xp, wp, bqp + 10 ** 8, mp, sp, table,
                          pre_shift=o["pre"])
    assert torch.count_nonzero(y[..., kp.wave.program.layer.out_c:]) == 0


def test_from_quant_matches_jax_oracle_from_quant():
    """A LayerQuant frozen from float weights by both packages drives
    the port's layer and the JAX oracle to the same bits."""
    jl, kp, o = build("grouped")
    rng = np.random.default_rng(4)
    w = rng.standard_normal(o["wq"].shape, np.float32) * 0.2
    b = rng.standard_normal(w.shape[-1]).astype(np.float32) * 0.1
    lq = quantize_layer(kp.wave.program.layer, w, b, 0.05, 0.07)
    want = np.asarray(jax_ref_from_quant(
        jl, jnp.asarray(o["xq"]), jax_quantize_layer(jl, w, b, 0.05, 0.07),
        relu=True))
    got = ops.wave_replay_q_from_quant(kp, torch.as_tensor(o["xq"]), lq)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_batch_is_per_image():
    _, kp, o = build("ragged_batch")
    whole = port_layer(kp, o)
    for i in range(o["xq"].shape[0]):
        one = port_layer(kp, dict(o, xq=o["xq"][i:i + 1]))
        assert torch.equal(whole[i:i + 1], one)


def test_cpu_runs_count_as_plain_not_launches():
    _, kp, o = build("dense")
    ops.reset_launch_count()
    for _ in range(3):
        port_layer(kp, o)
    assert ops.plain_count() == 3 and ops.launch_count() == 0
    ops.reset_launch_count()
    assert ops.plain_count() == 0


class _Override:
    """A program that answers as ``kp`` except for the given fields."""
    def __init__(self, kp, **fields):
        self._kp = kp
        self.__dict__.update(fields)

    def __getattr__(self, name):
        return getattr(self._kp, name)


def test_raw_launcher_raises_where_the_reference_raises():
    _, kp, o = build("dense")
    args = list(ops.pad_operands_q(
        kp, *(torch.as_tensor(o[k]) for k in ("xq", "wq", "bq", "m",
                                               "shift"))))
    table = torch.as_tensor(kp.operand_table())
    xp, wp, bqp, mp, sp = args

    def raw(*a, **kw):
        return wave_replay_q_raw(kp, *a, **kw)

    with pytest.raises(ValueError, match="int8"):
        raw(xp.to(torch.int32), wp, bqp, mp, sp, table)
    with pytest.raises(ValueError, match="int8"):
        raw(xp, wp.float(), bqp, mp, sp, table)
    with pytest.raises(ValueError, match="input"):
        raw(xp[:, 1:].contiguous(), wp, bqp, mp, sp, table)
    with pytest.raises(ValueError, match="weights"):
        raw(xp, wp[:, :, :-1].contiguous(), bqp, mp, sp, table)
    with pytest.raises(ValueError, match="m must be int32"):
        raw(xp, wp, bqp, mp.long(), sp, table)
    with pytest.raises(ValueError, match="shift must be int32"):
        raw(xp, wp, bqp, mp, sp[0], table)
    with pytest.raises(ValueError, match="bias_q must be int32"):
        raw(xp, wp, bqp[:, :-1], mp, sp, table)
    with pytest.raises(ValueError, match="operand table"):
        raw(xp, wp, bqp, mp, sp, table[:, :1])
    with pytest.raises(ValueError, match="residual"):
        raw(xp, wp, bqp, mp, sp, table, residual=xp)
    nc = xp.new_empty(tuple(xp.shape)[::-1]).permute(3, 2, 1, 0)
    nc.copy_(xp)
    with pytest.raises(ValueError, match="not contiguous"):
        raw(nc, wp, bqp, mp, sp, table)
    with pytest.raises(ValueError, match="not meta"):
        raw(*(t.to("meta") for t in args), table.to("meta"))
    # a residual program without its (int8) residual
    _, rkp, ro = build("residual")
    rargs = ops.pad_operands_q(
        rkp, *(torch.as_tensor(ro[k]) for k in ("xq", "wq", "bq", "m",
                                                 "shift")))
    rtab = torch.as_tensor(rkp.operand_table())
    with pytest.raises(ValueError, match="residual"):
        wave_replay_q_raw(rkp, *rargs, rtab)
    rp = ops.pad_residual_q(rkp, torch.as_tensor(ro["r"]))
    with pytest.raises(ValueError, match="int8 residual"):
        wave_replay_q_raw(rkp, *rargs, rtab, residual=rp.float())
    # grouped programs must be single-step over the full out_c
    _, gkp, go = build("grouped")
    gargs = ops.pad_operands_q(
        gkp, *(torch.as_tensor(go[k]) for k in ("xq", "wq", "bq", "m",
                                                 "shift")))
    gtab = torch.as_tensor(gkp.operand_table())
    with pytest.raises(ValueError, match="single-step"):
        wave_replay_q_raw(_Override(gkp, n_chain=2), *gargs, gtab)


def test_plain_version_is_the_launchers_cpu_route():
    _, kp, o = build("pool")
    args = ops.pad_operands_q(
        kp, *(torch.as_tensor(o[k]) for k in ("xq", "wq", "bq", "m",
                                               "shift")))
    table = torch.as_tensor(kp.operand_table())
    assert torch.equal(
        wave_replay_q_raw(kp, *args, table, pre_shift=o["pre"]),
        wave_replay_q_plain(kp, *args, table, pre_shift=o["pre"]))
