"""The port's sharded train step (``chanamq_tpu_torch.parallel``) against
the JAX package's ``make_sharded_train_step`` and the port's one-device
step, on the CPU over gloo.

The reference's multichip record (``__graft_entry__.py:90-121``): the
dryrun config (``seq_len=8, d_model=32, n_heads=4, d_ff=64,
n_layers=2``), ``init_params(PRNGKey(0))`` and ``synthetic_batch`` of 16
from the same key, on a dp2 x tp4 mesh of the conftest's 8 virtual CPU
devices. The same numbers, through numpy, go to 8 port ranks (processes
from a forkserver that has torch loaded, one torch thread each, gloo over
a file store) on a dp2 x tp4 mesh, and to the port's one-device step.

Tolerances, after one step:
- the loss within ``LOSS_RTOL`` (one bf16 step, 2^-8, of itself) of both:
  each side rounds its bf16 activations at other points (the port adds a
  row-split product's partial sums in float32 and rounds once more; GSPMD
  reduces as XLA chooses); measured 8e-5 and 2e-4 relative;
- each momentum tree (one step: the clipped gradient) within
  ``GRAD_STEPS`` bf16 steps at its largest value, the limit
  ``tests/test_torch_forecaster_train.py`` holds the one-device step to
  (measured 0.5% against the one-device step, 0.7% against the
  reference). Against the reference, ``embed/bias`` and ``pos`` may also
  differ by what the reference's own sharded and one-device steps differ
  by there: its gradients of a broadcast add are bf16 reductions whose
  partial sums GSPMD splits over devices (measured 3.5% apart; the port
  sums them in float32);
- each parameter tree within what its momentum difference allows (the
  step moves it by lr times its momentum), plus float32 rounding;
- bit for bit: the loss on every rank, every replicated leaf on all 8
  ranks, every sharded leaf on the two dp replicas of its shard.
"""

import math

import numpy as np
import pytest
import torch

from chanamq_tpu_torch.kernels import forecaster as fk
from chanamq_tpu_torch.models import forecaster as port
from chanamq_tpu_torch.parallel import mesh as pm

SMALL = dict(seq_len=8, d_model=32, n_heads=4, d_ff=64, n_layers=2)
WORLD = 8
BATCH = 16
LR = 1e-3
LOSS_RTOL = 2.0 ** -8
GRAD_STEPS = 3.0
JOIN_S = 120.0


def bf16_steps(n: float, want) -> float:
    """``n`` bf16 steps at the largest magnitude in ``want``."""
    top = float(np.abs(np.asarray(want, np.float64)).max())
    return n * 2.0 ** (math.floor(math.log2(top)) - 7)


def _rank(rank: int, world: int, store: str, params: dict, batch: tuple,
          results) -> None:
    """One rank: one sharded step from the full parameters, then the
    gathered parameters and momentum, the loss and the local shards."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        cfg = port.ForecasterConfig(**SMALL)
        mesh = pm.make_mesh(world, backend="gloo", device="cpu")
        full = port.params_from_numpy(params, cfg, "cpu")
        local, part = pm.place(mesh, full, tuple(
            torch.from_numpy(a) for a in batch))
        momentum = pm.place_params(mesh, port.init_momentum(full))
        step = pm.make_sharded_train_step(mesh, cfg, lr=LR)
        out_p, out_m, loss = step(local, momentum, part)
        assert out_p is local and out_m is momentum  # in place
        to_np = lambda tree: {k: v.numpy() for k, v in tree.items()}  # noqa
        results.put((rank, {
            "shape": mesh.shape, "loss": float(loss),
            "params": to_np(pm.gather_params(mesh, local)),
            "momentum": to_np(pm.gather_params(mesh, momentum)),
            "local": to_np(local)}))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, store: str, params: dict, batch: tuple) -> list:
    """``_rank`` on ``world`` processes from a forkserver that has torch
    loaded (``chip_smoke.run_processes``); their results by rank. Each
    rank must report and exit within ``JOIN_S``."""
    import chip_smoke

    return chip_smoke.run_processes(
        _rank, world, (world, store, params, batch), start="forkserver",
        preload=("torch", "torch.distributed",
                 "chanamq_tpu_torch.parallel.mesh"), timeout_s=JOIN_S)


@pytest.fixture(scope="module")
def reference():
    """The reference's dryrun inputs, its sharded step on the 8 virtual
    CPU devices and its one-device step, as numpy."""
    import jax

    from chanamq_tpu.models import forecaster as ref
    from chanamq_tpu.parallel import make_mesh, make_sharded_train_step
    from chanamq_tpu.parallel.mesh import place_batch, place_params

    cfg = ref.ForecasterConfig(**SMALL)
    key = jax.random.PRNGKey(0)
    params = ref.init_params(key, cfg)
    batch = ref.synthetic_batch(key, cfg, BATCH)
    mesh = make_mesh(WORLD)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {"dp": 2,
                                                              "tp": 4}
    step = make_sharded_train_step(mesh, cfg, ref.make_train_step(cfg, LR))
    as_np = lambda tree: {k: np.asarray(v) for k, v in tree.items()}  # noqa
    out = {"params": as_np(params),
           "batch": tuple(np.asarray(a) for a in batch)}
    one_p, one_m, one_l = jax.jit(ref.make_train_step(cfg, LR))(
        params, ref.init_momentum(params), batch)
    sh_p, sh_m, sh_l = step(place_params(mesh, params),
                            place_params(mesh, ref.init_momentum(params)),
                            place_batch(mesh, batch))
    out["sharded"] = (float(sh_l), as_np(sh_p), as_np(sh_m))
    out["one_device"] = (float(one_l), as_np(one_p), as_np(one_m))
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _held(got_p, got_m, want_p, want_m, extra=None) -> dict:
    """Each tree's momentum and parameters to the module's limits; returns
    each kind's largest error relative to its limit."""
    worst = {}
    for k in want_m:
        dm = np.abs(got_m[k].astype(np.float64) - want_m[k])
        limit = bf16_steps(GRAD_STEPS, want_m[k]) + (extra or {}).get(k, 0.0)
        dp = np.abs(got_p[k].astype(np.float64) - want_p[k])
        p_limit = (LR * (1 + 2.0 ** -20) * float(dm.max())
                   + 8 * 2.0 ** -24 * float(np.abs(want_p[k]).max()))
        for kind, err, lim in (("momentum", dm, limit), ("params", dp,
                                                         p_limit)):
            ratio = float(err.max()) / lim
            assert ratio <= 1.0, (kind, k, float(err.max()), lim)
            worst[kind] = max(worst.get(kind, (0.0, "")), (ratio, k))
    return worst


def test_sharded_step_matches_reference_and_one_device(tmp_path, reference):
    """One dp2 x tp4 step on 8 gloo ranks against the reference's sharded
    step and the port's one-device step, to the module's limits; the
    replicated leaves bit-equal on every rank."""
    params, batch = reference["params"], reference["batch"]
    res = run_ranks(WORLD, str(tmp_path / "store"), params, batch)
    assert len(res) == WORLD
    assert all(r["shape"] == {"dp": 2, "tp": 4} for r in res)

    cfg = port.ForecasterConfig(**SMALL)
    one_p = port.params_from_numpy(params, cfg, "cpu")
    one_m = port.init_momentum(one_p)
    _, _, one_loss = port.make_train_step(cfg, lr=LR)(
        one_p, one_m, tuple(torch.from_numpy(a.copy()) for a in batch))
    one_p = {k: v.numpy() for k, v in one_p.items()}
    one_m = {k: v.numpy() for k, v in one_m.items()}

    loss = res[0]["loss"]
    assert all(r["loss"] == loss for r in res)  # bit for bit on every rank
    ref_loss, ref_p, ref_m = reference["sharded"]
    _, ref1_p, ref1_m = reference["one_device"]
    for want in (ref_loss, float(one_loss)):
        assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)

    gathered_p, gathered_m = res[0]["params"], res[0]["momentum"]
    for r in res[1:]:
        for k in gathered_p:
            assert np.array_equal(r["params"][k], gathered_p[k]), k
            assert np.array_equal(r["momentum"][k], gathered_m[k]), k
    _held(gathered_p, gathered_m, one_p, one_m)
    spread = {k: float(np.abs(ref_m[k].astype(np.float64) - ref1_m[k]).max())
              for k in ("embed/bias", "pos")}
    _held(gathered_p, gathered_m, ref_p, ref_m, spread)

    for rank, r in enumerate(res[1:], start=1):
        for k, local in r["local"].items():
            same = res[0]["local"][k] if not pm._spec_for(k) else \
                res[rank % 4]["local"][k]  # its shard's replica on dp rank 0
            assert np.array_equal(local, same), (rank, k)


RULE_WORLDS = (1, 2, 4, 8)


@pytest.mark.parametrize(
    "case", ["qkv-regroup"] + [f"tp-rule-{n}" for n in RULE_WORLDS])
def test_mesh_layout(case):
    """qkv-regroup: ``regroup_qkv`` / ``ungroup_qkv`` round-trip bit for
    bit at tp 1, 2 and 4, and a rank's column block of the regrouped
    product is [q | k | v] of its heads: the attention on it is the full
    attention's output columns of those heads. tp-rule-n: ``mesh_shape``
    gives the reference's ``make_mesh(n)`` mesh shape."""
    if case.startswith("tp-rule-"):
        from chanamq_tpu.parallel import make_mesh

        n = int(case.rsplit("-", 1)[1])
        assert pm.mesh_shape(n) == tuple(make_mesh(n).devices.shape)
        return
    rng = np.random.default_rng(3)
    d, heads, b, t = 32, 4, 2, 8
    qkv = torch.from_numpy(rng.normal(size=(d, 3 * d)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(b, t, d)).astype(np.float32))
    full = fk.causal_attention_ref(x @ qkv, heads)
    for tp in (1, 2, 4):
        grouped = pm.regroup_qkv(qkv, tp)
        assert torch.equal(pm.ungroup_qkv(grouped, tp), qkv)
        width = d // tp
        for r, block in enumerate(grouped.chunk(tp, dim=1)):
            cols = [qkv[:, part * d + r * width:part * d + (r + 1) * width]
                    for part in range(3)]
            assert torch.equal(block, torch.cat(cols, dim=1))
            got = fk.causal_attention_ref(x @ block, heads // tp)
            assert torch.allclose(got, full[..., r * width:(r + 1) * width],
                                  rtol=0, atol=1e-5)


def test_chip_smoke_sharded_rehearsal():
    """chip_smoke's [sharded-train] phase on the CPU at the dryrun config:
    one rank in this process and a tp = 2 pair of spawned ranks over
    gloo, 5 steps each, held by ``check_sharded`` to the one-device step
    (the launch counts are checked on a card only), every kernel call of
    each rank's first step replayed (on the CPU each wrapper is its plain
    version, so the replay agrees exactly)."""
    import chip_smoke

    res = chip_smoke.phase_sharded_train(
        [("one", "gloo", ["cpu"], None), ("tp2", "gloo", ["cpu"] * 2, 2)],
        0, cfg_kwargs=SMALL)
    assert res["one"]["ranks"][0]["shape"] == {"dp": 1, "tp": 1}
    assert [r["shape"] for r in res["tp2"]["ranks"]] == [{"dp": 1, "tp": 2}] * 2
    # one rank sums exactly what the one-device step sums
    assert res["one"]["loss_rel_err"] == {1: 0.0, 5: 0.0}
    assert all(len(run["ranks"][0]["losses"]) == 5 for run in res.values())
    for r in res["tp2"]["ranks"]:
        assert set(r["replay"]) == set(chip_smoke.SHARDED_KERNELS)
        assert all(row["max_abs_err"] == 0.0 for row in r["replay"].values())
    # tp = 2 halves the heads and the w1 columns a rank's kernels see
    att = res["tp2"]["ranks"][0]["replay"]["causal_attention"]["shapes"]
    assert list(att) == [f"{BATCH}x{SMALL['seq_len']}x{3 * 32 // 2}"]
