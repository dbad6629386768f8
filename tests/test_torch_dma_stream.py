"""The tile-stream probes B5-B7 (rbl_tpu_torch.benchmarks.dma_stream_bench)
against the JAX package's Pallas kernels (benchmarks/dma_stream_bench.py,
in interpret mode) on the CPU.

The same numpy-seeded vals, seed and xt go through both.  Sums of many
terms of both signs cancel, so each output entry is held to
|out − ref| ≤ 1e-5 · Σ|terms|, with ref and Σ|terms| in f64.
"""

import importlib.util
import itertools
import json
import pathlib

import numpy as np
import pytest
import torch

from _torch_parity import CPU  # noqa: F401  (caps torch's threads)
from rbl_tpu_torch.benchmarks import dma_stream_bench as tds

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_kernels():
    """make_stream, make_stream_dot, make_manual of the JAX benchmark,
    loaded from its file as it stands."""
    spec = importlib.util.spec_from_file_location(
        "jax_dma_stream_bench", ROOT / "benchmarks" / "dma_stream_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._build_kernels()


def _inputs(S, bm, U, seed=0):
    rng = np.random.default_rng(seed)
    CH = bm * U
    vals = rng.standard_normal((S * CH, 128)).astype(np.float32)
    seed_tile = rng.standard_normal((8, 128)).astype(np.float32)
    xt = rng.standard_normal((8, 128)).astype(np.float32)
    return vals, seed_tile, xt


CASES = [(1, 8, 2), (3, 8, 2), (5, 16, 4)]


@pytest.mark.parametrize("variant", tds.VARIANTS)
@pytest.mark.parametrize("S,bm,U", CASES)
def test_probe_matches_pallas_kernel(jax_kernels, variant, S, bm, U):
    import jax.numpy as jnp

    make_stream, make_stream_dot, make_manual = jax_kernels
    vals, seed_tile, xt = _inputs(S, bm, U, seed=S * 100 + bm)
    CH = bm * U
    jargs = (jnp.asarray(vals), jnp.asarray(seed_tile))
    targs = (torch.from_numpy(vals), torch.from_numpy(seed_tile))
    if variant == "stream":
        jfn, tfn = make_stream(S, CH, True), tds.make_stream(S, CH)
        plain = tds.stream_reference(*targs, S=S, CH=CH)
    elif variant == "stream_dot":
        jargs += (jnp.asarray(xt),)
        targs += (torch.from_numpy(xt),)
        jfn, tfn = make_stream_dot(S, CH, bm, U, True), tds.make_stream_dot(S, CH, bm, U)
        plain = tds.stream_dot_reference(*targs, S=S, CH=CH, bm=bm, U=U)
    else:
        jfn, tfn = make_manual(S, CH, True), tds.make_manual(S, CH)
        plain = tds.manual_reference(*targs, S=S, CH=CH)
    ref, scale = tds.reference_f64(variant, *targs)
    j_out = np.array(jfn(*jargs))
    t_out = tfn(*targs)
    assert t_out.shape == (8, 128) and t_out.dtype == torch.float32
    assert tds.error_ratio(torch.from_numpy(j_out), ref, scale) <= 1.0
    assert tds.error_ratio(t_out, ref, scale) <= 1.0
    assert torch.equal(t_out, plain)  # the CPU path is the plain version
    # the port against the Pallas kernel directly: within both tolerances
    diff = (t_out.double() - torch.from_numpy(j_out).double()).abs()
    assert bool((diff <= 2 * tds.TOL * scale).all())


def test_error_rule_catches_a_wrong_sum():
    vals, seed_tile, _ = _inputs(4, 8, 2)
    v, s = torch.from_numpy(vals), torch.from_numpy(seed_tile)
    ref, scale = tds.reference_f64("stream", v, s)
    out = tds.stream_reference(v, s, S=4, CH=16)
    assert tds.error_ratio(out, ref, scale) <= 1.0
    short = tds.stream_reference(v[:48], s, S=3, CH=16)  # one chunk missed
    assert tds.error_ratio(short, ref, scale) > 1.0


def test_cpu_wrappers_count_no_launches_and_check_operands():
    vals, seed_tile, xt = _inputs(2, 8, 2)
    v, s, x = map(torch.from_numpy, (vals, seed_tile, xt))
    before = (tds.dma_stream.launches, tds.dma_stream_dot.launches,
              tds.dma_stream_manual.launches)
    tds.make_stream(2, 16)(v, s)
    tds.make_stream_dot(2, 16, 8, 2)(v, s, x)
    tds.make_manual(2, 16)(v, s)
    assert (tds.dma_stream.launches, tds.dma_stream_dot.launches,
            tds.dma_stream_manual.launches) == before
    with pytest.raises(ValueError):
        tds.make_stream(3, 16)(v, s)  # vals holds 2 chunks, not 3
    with pytest.raises(ValueError):
        tds.make_stream_dot(2, 16, 4, 2)(v, s, x)  # CH is not bm·U
    with pytest.raises(TypeError):
        tds.make_manual(2, 16)(v.double(), s)
    with pytest.raises(ValueError):
        tds.make_stream(2, 16)(v, s.to("meta"))


class _Clock:
    """A clock that advances by the given steps, one per reading."""

    def __init__(self, steps):
        self.t, self.steps = 0.0, iter(steps)

    def __call__(self):
        self.t += next(self.steps)
        return self.t


def test_time_chained_raises_on_a_non_positive_marginal():
    vals, seed_tile, _ = _inputs(2, 8, 2)
    call = tds.make_stream(2, 16)
    v, s = torch.from_numpy(vals), torch.zeros((8, 128))
    # every run reads the same elapsed time: the marginal is 0, twice
    with pytest.raises(RuntimeError, match="≤ 0"):
        tds.time_chained(call, v, s, 2, clock=_Clock(itertools.cycle([0.0, 1.0])))


def test_time_chained_is_the_marginal_per_call():
    vals, _, _ = _inputs(2, 8, 2)
    call = tds.make_stream(2, 16)
    v, s = torch.from_numpy(vals), torch.zeros((8, 128))
    # warm-up 1 s, then runs of r calls take 0.5 + 0.25·r s
    r = 2
    steps = [0.0, 1.0] + [0.0, 0.5 + 0.25 * r] * 3 + [0.0, 0.5 + 1.0 * r] * 3
    dt = tds.time_chained(call, v, s, r, clock=_Clock(steps))
    assert dt == pytest.approx(0.25)


def test_main_runs_the_plain_versions_on_the_cpu(capsys):
    assert tds.main(["--mb", "1", "--reps", "1", "--configs", "8:2,16:8",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device: cpu")
    assert sum("[row]" in ln for ln in lines) == 6
    last = json.loads(lines[-1])
    assert last["metric"] == "dma_stream_sweep" and last["device"] == "cpu"
    assert [(r["bm"], r["U"], r["variant"]) for r in last["rows"]] == [
        (bm, U, v) for bm, U in ((8, 2), (16, 8)) for v in tds.VARIANTS]
    assert all(r["ms"] > 0 and r["kernel_ms"] is None for r in last["rows"])


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tds.main(["--mb", "1"])
