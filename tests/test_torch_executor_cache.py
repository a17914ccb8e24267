"""The port's executor cache against the JAX package's: one call sequence
driven through both packages' layer executors, each with a fresh metrics
registry and an empty cache bounded at 2 entries, gives the same hits,
misses, evictions, ``poisoned`` counts and cache sizes after every call.
The sequence covers LRU eviction, a custom ``conv_fn`` keyed by its
token, two callables sharing a ``conv_fn_name``, a call that fails (its
entry is evicted) and a build that fails (no entry is made). Plus the
span tracer: execute spans per executor call and compile/run spans
around the cache, and the graph-level cache keyed by topology."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import decomposition as jdec  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.core import decomposition as tdec  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402
from repro_torch.core.graph import chain_graph  # noqa: E402
from repro_torch.kernels.wave_replay.ref import fp32_error  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small ops: one intra-op thread per process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COUNTERS = ("hits", "misses", "evictions", "poisoned")


class Side:
    """One package's executors, cache and registry, driven by name."""

    def __init__(self, dec, sched, stream, metrics, asarray):
        self.dec, self.sched, self.stream = dec, sched, stream
        self.metrics, self.asarray = metrics, asarray
        self.reg = metrics.MetricsRegistry()

    def layer(self, name, in_c):
        return self.dec.ConvLayer(name, 8, 8, in_c, 6, 3, pad=1)

    def run(self, mode, layer, conv_fn=None, conv_fn_name=None):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((1, 8, 8, layer.in_c), np.float32)
        w = rng.standard_normal((3, 3, layer.in_c, 6), np.float32)
        prog = self.sched.compile_layer(
            layer, self.dec.evaluate(layer, 2, 1, 1, 1))
        fn = self.stream.run_layer_wave if mode == "wave" \
            else self.stream.run_layer_scheduled
        arg = self.sched.partition_waves(prog) if mode == "wave" else prog
        return fn(arg, self.asarray(x), self.asarray(w), None,
                  conv_fn=conv_fn, conv_fn_name=conv_fn_name)

    def state(self):
        reg = self.reg
        return tuple(reg.counter(f"executor_cache.{c}").value
                     for c in COUNTERS) + (
            self.stream.executor_cache_size(),)


def jax_conv(xt, wt):
    return jstream.conv2d_direct(xt, wt, 1, 0)


def torch_conv(xt, wt):
    return tstream.conv2d_direct(xt, wt, 1, 0)


def failing_conv(xt, wt):
    raise RuntimeError("conv backend failed")


def drive(side, conv):
    """The call sequence; returns the state after each step."""
    a, b = side.layer("a", 4), side.layer("b", 5)
    out = []

    def step(fn, *args, **kw):
        try:
            fn(*args, **kw)
        except RuntimeError:
            out.append("raised")
        out.append(side.state())

    with side.metrics.use_registry(side.reg):
        side.stream.clear_executor_cache()
        side.stream.set_executor_cache_limit(2)
        try:
            step(side.run, "wave", a)                 # miss
            step(side.run, "wave", a)                 # hit
            step(side.run, "scan", a)                 # miss
            step(side.run, "wave", b)                 # miss, evicts wave a
            step(side.run, "wave", a)                 # miss, evicts scan a
            step(side.run, "wave", a, conv_fn=conv)   # token: miss
            step(side.run, "wave", a, conv_fn=conv)   # same token: hit
            step(side.run, "wave", a, conv_fn=failing_conv)   # poisoned
            step(side.run, "scan", a, conv_fn=lambda *t: conv(*t),
                 conv_fn_name="same")                 # named: miss
            step(side.run, "scan", a, conv_fn=lambda *t: conv(*t),
                 conv_fn_name="same")                 # another fn: hit

            def bad_build():
                raise RuntimeError("build failed")
            step(side.stream._call_cached, ("no-such-key",), bad_build)
        finally:
            side.stream.clear_executor_cache()
            side.stream.set_executor_cache_limit(64)
    return out


def test_cache_counts_match_the_reference():
    jside = Side(jdec, jsched, jstream, jmetrics, jnp.asarray)
    tside = Side(tdec, tsched, tstream, tmetrics, torch.as_tensor)
    want = drive(jside, jax_conv)
    got = drive(tside, torch_conv)
    assert got == want
    # (hits, misses, evictions, poisoned, size) at the end
    assert got[-1] == (3, 8, 4, 1, 2)
    assert got.count("raised") == 2
    # a failing call and a failing build leave no entry behind
    assert got[got.index("raised") + 1][-1] == 1


def test_limit_must_be_positive():
    with pytest.raises(ValueError, match=">= 1"):
        tstream.set_executor_cache_limit(0)


def test_tracer_spans_per_call_and_cache_phase():
    tside = Side(tdec, tsched, tstream, tmetrics, torch.as_tensor)
    tracer = ttrace.Tracer()
    l = tside.layer("traced", 4)
    tstream.clear_executor_cache()
    with tmetrics.use_registry(tside.reg), ttrace.use_tracer(tracer):
        tside.run("wave", l)
        tside.run("wave", l)
        tside.run("scan", l)
    tstream.clear_executor_cache()
    execute = [s.name for s in tracer.spans("execute")]
    assert execute == ["wave:traced", "wave:traced", "scan:traced"]
    assert tracer.span_count("compile") == 2
    assert tracer.span_count("run") == 1
    assert tside.state()[:2] == (1, 2)


def test_graph_cache_is_keyed_by_topology():
    """Two graphs of one name and layer geometry but other node flags (no
    ReLU) never share an entry; a repeated call hits."""
    l1 = tdec.ConvLayer("c1", 8, 8, 3, 4, 3, pad=1)
    l2 = tdec.ConvLayer("c2", 8, 8, 4, 4, 3, pad=1)
    g1 = chain_graph((l1, l2), name="g")
    g2 = chain_graph((l1, l2), name="g", relu=False)
    assert g1.topology_key != g2.topology_key
    plans = [tdec.plan_decomposition(l, 128 * 1024) for l in (l1, l2)]
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, 8, 8, 3), np.float32))
    weights = [(torch.as_tensor(rng.standard_normal(
        (3, 3, l.in_c, 4), np.float32) * 0.3), None) for l in (l1, l2)]
    reg = tmetrics.MetricsRegistry()
    tstream.clear_executor_cache()
    with tmetrics.use_registry(reg):
        y = tstream.run_graph_streamed(g1, plans, x, weights, mode="wave")
        tstream.run_graph_streamed(g1, plans, x, weights, mode="wave")
        y2 = tstream.run_graph_streamed(g2, plans, x, weights, mode="wave")
    tstream.clear_executor_cache()
    assert reg.counter("executor_cache.hits").value == 1
    assert reg.counter("executor_cache.misses").value == 2
    for got, g in ((y, g1), (y2, g2)):
        err, tol = fp32_error(got, tstream.run_graph_reference(
            g, weights, x)[g.output])
        assert err <= tol
    assert bool((y2 < 0).any()) and not bool((y < 0).any())
