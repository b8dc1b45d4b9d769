"""Rank worker for ``tests/test_torch_lm_ranks.py``: one process of a gloo
group on the CPU, running the port's language model across ranks under
``sharding.use_rules`` and handing each result back to the parent.

It imports only ``repro_torch``, torch and numpy — never ``jax`` or
``repro``. Parameters arrive as numpy trees in the port's layout (whole
leaves; each rank keeps its slice through ``place``), configs as the
port's ``ModelConfig``, batches as global numpy arrays (each rank takes its
slab through ``batch_slab``).

Cases (dicts, run in order; every rank runs every case), each with
``"mesh"`` ``(data, model)`` and ``"profile"``:

* ``{"kind": "moe", "cfg", "params", "x"}`` — ``moe_apply`` on the rank's
  slab of ``x``: ``{"y", "aux", "metrics", "bytes"}``;
* ``{"kind": "serve", "cfg", "params", "tokens", "prompt_len"}`` —
  ``make_prefill_step`` on the slab's first ``prompt_len`` tokens into
  caches of ``max_len`` (default: the tokens' length) made under the
  rules, then ``make_decode_step`` on each later token, or with
  ``greedy`` n on n greedy tokens: ``{"prefill", "decode",
  "cache_bytes", "ssm_bytes"}`` (this rank's logits, its caches' bytes
  and its mamba layers' SSM states' bytes);
* ``{"kind": "train", "cfg", "params", "batches", "compress",
  "microbatches", "ckpt_dir"}`` — ``make_train_step`` over the batches:
  ``{"metrics", "params"}`` (the params gathered whole on rank 0), and,
  with ``ckpt_dir``, the state saved sharded before and after the steps
  (``save_sharded``, steps 0 and 1) and restored with ``sharding_tree=``:
  ``"restored_equal"`` (bitwise against the live slices) and
  ``"slices"`` (this rank's restored slices of a few leaves);
* ``{"kind": "thread_grad", "cfg", "params", "batch"}`` — ``loss_fn``
  under the rules, its gradient taken once on this thread and once from
  another thread (as autograd's device thread recomputes a checkpointed
  layer on a card): ``{"same": bool}``;
* ``{"kind": "fsdp_gather", "shapes", "dims", "seed"}`` — one
  ``fsdp_gather`` of this rank's seeded float32 slices over ``data`` in
  bf16, leaf j along ``dims[j]``, then its backward from seeded bf16
  cotangents of the whole leaves: ``{"whole", "grad", their dtypes,
  "sent_forward", "sent_backward", "calls"}``;
* ``{"kind": "fsdp_wire", "cfg", "params", "batch"}`` — ``loss_fn`` and its
  gradient under the rules with every ``fsdp_gather`` the model calls
  recorded: per call of the forward and of the backward (remat's
  recompute) its leaves' dtypes, the gathered layer leaves still alive
  between the forward and the backward, and the ``fsdp`` bytes and calls;
* ``{"kind": "tp_grads", "cfg", "inputs", "live"}`` — the tensor-parallel
  MLP and the sequence-split decode attention on whole seeded inputs and
  the gradients of this rank's part (:func:`_tp_grads`);
* ``{"kind": "mamba_norm", "inputs", "eps"}`` — mamba2's gated norm over
  the line (``mamba2._gated_norm`` with the tp line) on this rank's
  channels of whole seeded inputs, and the gradients of ``sum(out *
  cot)`` over its part (:func:`_mamba_norm`);
* ``{"kind": "restore", "cfg", "ckpt_dir", "step"}`` — a whole train state's
  checkpoint restored with ``sharding_tree=``: every leaf's slice;
* ``{"kind": "step_counts", "cfg", "params", "step", "seq", "tokens",
  "labels"}`` — one ``make_train_step`` / ``make_prefill_step`` /
  ``make_decode_step`` (``step``: "train", "prefill" or "decode") at the
  dry-run's shapes: int32 tokens (and labels), caches of ``seq`` positions
  made under the rules, a decode step at position ``seq - 1``; the comm's
  ``sent`` / ``received`` / ``calls`` by kind from a reset just before the
  step, and a training step's metrics;
* ``{"kind": "stall"}`` — rank 0 starts an all-to-all that rank 1 never
  joins: the error's type and the seconds until it was raised.
"""

import datetime
import os
import pickle
import queue as queues
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 30
ARRIVAL_TIMEOUT_S = 120
SLICE_KEYS = ("params/embed", "params/layers/0/moe/experts_up",
              "opt/mu/layers/0/moe/experts_down", "residual/embed")


def _rules(case):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import ShardingRules

    return ShardingRules.for_mesh(make_local_mesh(*case["mesh"]),
                                  case["profile"])


def _params(case, rules, dtype=torch.float32):
    from repro_torch.sharding.placement import place

    host = _as_torch(case["params"], dtype)
    return place(host, rules)


def _as_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _as_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v, dtype) for v in tree]
    return torch.from_numpy(np.array(tree)).to(dtype)


def _slab(x, rules):
    from repro_torch.sharding.placement import batch_slab

    return batch_slab(torch.from_numpy(np.asarray(x)), rules).contiguous()


def _moe(case, rules):
    from repro_torch.core.collectives import mesh_comm
    from repro_torch.models.moe import moe_apply
    from repro_torch.sharding import use_rules

    comm = mesh_comm(rules.mesh)
    comm.reset_counts()
    params = _params(case, rules)
    with use_rules(rules):
        y, aux, metrics = moe_apply(params, case["cfg"],
                                    _slab(case["x"], rules))
    return {"y": y.numpy(), "aux": float(aux),
            "metrics": {k: int(v) for k, v in metrics.items()},
            "bytes": {"sent": dict(comm.sent),
                      "received": dict(comm.received)}}


def _serve(case, rules):
    from repro_torch.models import init_caches
    from repro_torch.sharding import use_rules
    from repro_torch.train import make_decode_step, make_prefill_step

    cfg = case["cfg"]
    params = _params(case, rules)
    toks = _slab(case["tokens"], rules)
    n = case["prompt_len"]
    greedy = case.get("greedy", 0)
    with use_rules(rules):
        caches = init_caches(cfg, toks.shape[0],
                             case.get("max_len", toks.shape[1]),
                             device="cpu")
        logits, caches = make_prefill_step(cfg)(
            params, {"tokens": toks[:, :n]}, caches)
        out = {"prefill": logits.numpy(), "decode": [],
               "cache_bytes": sum(t.numel() * t.element_size()
                                  for c in caches for t in c
                                  if isinstance(t, torch.Tensor)),
               "ssm_bytes": sum(c.ssm.numel() * c.ssm.element_size()
                                for c in caches if hasattr(c, "ssm"))}
        feeds = [toks[:, i:i + 1] for i in range(n, toks.shape[1])]
        for i in range(greedy or len(feeds)):
            feed = logits.argmax(-1)[:, None] if greedy else feeds[i]
            logits, caches = make_decode_step(cfg)(
                params, {"tokens": feed}, caches)
            out["decode"].append(logits.numpy())
    return out


def _step_counts(case, rules):
    from repro_torch.core.collectives import mesh_comm
    from repro_torch.models import init_caches
    from repro_torch.sharding import use_rules
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_decode_step, make_prefill_step,
                                   make_train_step)

    cfg, kind = case["cfg"], case["step"]
    params = _params(case, rules)
    batch = {"tokens": _slab(case["tokens"], rules)}
    comm = mesh_comm(rules.mesh)
    out = {}
    with use_rules(rules):
        if kind == "train":
            batch["labels"] = _slab(case["labels"], rules)
            state = init_train_state(cfg, params)
            step = make_train_step(cfg, AdamWConfig())
            comm.reset_counts()
            _, m = step(state, batch)
            out["metrics"] = {k: float(v) for k, v in m.items()}
        else:
            caches = init_caches(cfg, batch["tokens"].shape[0], case["seq"],
                                 device="cpu")
            if kind == "decode":
                caches = [c._replace(length=case["seq"] - 1)
                          if hasattr(c, "length") else c for c in caches]
            maker = make_prefill_step if kind == "prefill" \
                else make_decode_step
            comm.reset_counts()
            maker(cfg)(params, batch, caches)
    out.update(sent=dict(comm.sent), received=dict(comm.received),
               calls=dict(comm.calls))
    return out


def _whole(tree, rules, specs):
    """The whole leaves on rank 0 (None elsewhere), as numpy."""
    from repro_torch.sharding.placement import gather_full
    from repro_torch.train.optimizer import tree_leaves

    out = []
    for leaf, (_, spec) in zip(tree_leaves(tree), specs):
        full = gather_full(leaf, spec, rules, root=0)
        out.append(None if full is None else full.numpy())
    return out


def _train(case, rules):
    from repro_torch.checkpoint import restore_checkpoint, save_sharded
    from repro_torch.checkpoint.store import _leaves
    from repro_torch.sharding import leaf_pspecs, use_rules
    from repro_torch.sharding.placement import global_params, named_shardings
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)

    cfg = case["cfg"]
    params = _params(case, rules)
    state = init_train_state(cfg, params, compress=case["compress"])
    step_fn = make_train_step(cfg, AdamWConfig(warmup_steps=1),
                              compress_grads=case["compress"],
                              microbatches=case.get("microbatches", 1))
    ckpt = case.get("ckpt_dir")
    whole_state = None
    if ckpt:
        # the state's whole-leaf template and its shardings, by path
        g = global_params(cfg, torch.float32)
        whole_state = init_train_state(cfg, g, compress=case["compress"])
        shardings = named_shardings(whole_state, rules)
        save_sharded(ckpt, 0, state, shardings)
    metrics = []
    with use_rules(rules):
        for b in case["batches"]:
            state, m = step_fn(state, {k: _slab(v, rules)
                                       for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics,
           "params": _whole(state.params, rules,
                            leaf_pspecs(global_params(cfg), rules))}
    if ckpt:
        save_sharded(ckpt, 1, state, shardings)
        back = restore_checkpoint(ckpt, whole_state, step=1, device="cpu",
                                  sharding_tree=shardings)
        live = dict(_leaves(state))
        got = dict(_leaves(back))
        out["restored_equal"] = all(
            torch.equal(torch.as_tensor(live[k]), torch.as_tensor(got[k]))
            for k in live)
        out["slices"] = {k: got[k].numpy() for k in SLICE_KEYS if k in got}
    return out


def _thread_grad(case, rules):
    import threading

    from repro_torch.models import loss_fn
    from repro_torch.sharding import use_rules
    from repro_torch.train.optimizer import tree_leaves

    params = _params(case, rules)
    batch = {k: _slab(v, rules) for k, v in case["batch"].items()}
    grads = []
    for threaded in (False, True):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        from repro_torch.train.optimizer import tree_map
        tracked = tree_map(lambda _: next(it), params)
        with use_rules(rules):
            loss, _ = loss_fn(tracked, case["cfg"], batch)
        out = {}

        def run():
            try:
                out["g"] = torch.autograd.grad(loss, leaves,
                                               materialize_grads=True)
            except Exception as e:  # reported to the parent
                out["error"] = repr(e)

        if threaded:
            t = threading.Thread(target=run)
            t.start()
            t.join()
        else:
            run()
        if "error" in out:
            return {"same": False, "error": out["error"]}
        grads.append(out["g"])
    return {"same": all(torch.equal(a, b) for a, b in zip(*grads))}


def _fsdp_gather(case, rules):
    from repro_torch.core.collectives import fsdp_gather, mesh_comm

    comm = mesh_comm(rules.mesh)
    comm.reset_counts()
    me = comm.index(("data",))
    xs = [torch.from_numpy(np.random.default_rng(case["seed"] + 10 * j + me)
                           .standard_normal(shape).astype(np.float32))
          .requires_grad_() for j, shape in enumerate(case["shapes"])]
    whole = fsdp_gather(xs, comm, ("data",), case["dims"], torch.bfloat16)
    sent = comm.sent["fsdp"]
    cot = [torch.from_numpy(np.random.default_rng(
        case["seed"] + 100 + 10 * j + me).standard_normal(tuple(w.shape))
        .astype(np.float32)).to(torch.bfloat16) for j, w in enumerate(whole)]
    torch.autograd.backward(whole, cot)
    return {"whole": [w.detach().float().numpy() for w in whole],
            "whole_dtype": sorted({str(w.dtype) for w in whole}),
            "grad": [x.grad.numpy() for x in xs],
            "grad_dtype": sorted({str(x.grad.dtype) for x in xs}),
            "sent_forward": sent, "sent_backward": comm.sent["fsdp"] - sent,
            "calls": comm.calls["fsdp"]}


def _fsdp_wire(case, rules):
    import weakref

    import repro_torch.models.transformer as tr
    from repro_torch.core.collectives import mesh_comm
    from repro_torch.sharding import use_rules
    from repro_torch.train.optimizer import tree_leaves, tree_map

    comm = mesh_comm(rules.mesh)
    comm.reset_counts()
    params = tree_map(lambda p: p.requires_grad_(), _params(case, rules))
    batch = {k: _slab(v, rules) for k, v in case["batch"].items()}
    seen = {"phase": "forward", "forward": [], "backward": []}
    orig = tr.fsdp_gather

    def recorded(xs, *args):
        out = orig(xs, *args)
        seen[seen["phase"]].append([(str(w.dtype), weakref.ref(w))
                                    for w in out])
        return out

    tr.fsdp_gather = recorded
    try:
        with use_rules(rules):
            loss, _ = tr.loss_fn(params, case["cfg"], batch)
        sent = comm.sent["fsdp"]
        # the first gather is the embedding's, which the cross entropy
        # keeps for its backward
        alive = sum(ref() is not None for call in seen["forward"][1:]
                    for _, ref in call)
        seen["phase"] = "backward"
        loss.backward()
    finally:
        tr.fsdp_gather = orig
    return {"forward": [[d for d, _ in call] for call in seen["forward"]],
            "backward": [[d for d, _ in call] for call in seen["backward"]],
            "alive_after_forward": alive, "sent_forward": sent,
            "sent": comm.sent["fsdp"], "received": comm.received["fsdp"],
            "calls": comm.calls["fsdp"],
            "grads": [p.grad is not None and bool(torch.isfinite(p.grad)
                                                  .all())
                      for p in tree_leaves(params)]}


def _tp_grads(case, rules):
    """The Megatron MLP (``mlp_apply`` under the rules: ``tp_copy`` in,
    the row-split sum out) and the sequence-split decode attention
    (``attention.sp_attend``, the query's heads gathered as a decode step
    gathers them) on seeded whole inputs, each rank its slices, and the
    gradients of ``sum(y * cot)`` over this rank's part of ``y``: the
    MLP's with respect to ``x`` and this rank's weight slices, the
    attention's to this rank's query heads and its block of k and v."""
    from repro_torch.core.collectives import all_gather_cat
    from repro_torch.models.attention import sp_attend
    from repro_torch.models.layers import mlp_apply
    from repro_torch.models.tensor_parallel import tp_group
    from repro_torch.sharding import use_rules

    cfg = case["cfg"]
    g = {k: torch.from_numpy(v) for k, v in case["inputs"].items()}
    out = {}
    with use_rules(rules):
        tp = tp_group()
        p, r = tp.size, tp.index
        f = g["w_up"].shape[1] // p
        w = {"w_up": g["w_up"][:, r * f:(r + 1) * f],
             "w_gate": g["w_gate"][:, r * f:(r + 1) * f],
             "w_down": g["w_down"][r * f:(r + 1) * f]}
        w = {k: v.clone().requires_grad_() for k, v in w.items()}
        x = g["x"].clone().requires_grad_()
        y = mlp_apply(w, x, cfg.mlp, d_ff=g["w_up"].shape[1])
        (y * g["cot_y"]).sum().backward()
        out["mlp"] = {"y": y.detach().numpy(), "x": x.grad.numpy(),
                      **{k: v.grad.numpy() for k, v in w.items()}}
        h = cfg.n_heads // p
        span = g["k"].shape[1] // p
        q = g["q"][:, r * h:(r + 1) * h].clone().requires_grad_()
        k = g["k"][:, r * span:(r + 1) * span].clone().requires_grad_()
        v = g["v"][:, r * span:(r + 1) * span].clone().requires_grad_()
        lo, hi = case["live"]
        q_all = all_gather_cat(q[None], tp.comm, tp.dims, "sp")
        q_all = q_all.transpose(0, 1).reshape(q.shape[0], -1, q.shape[2])
        att = sp_attend(q_all, k, v, min(max(lo - r * span, 0), span),
                        min(max(hi - r * span, 0), span), cfg, tp)
        mine = att[:, r * h:(r + 1) * h]
        (mine * g["cot_att"][:, r * h:(r + 1) * h]).sum().backward()
        out["sp"] = {"out": mine.detach().numpy(), "q": q.grad.numpy(),
                     "k": k.grad.numpy(), "v": v.grad.numpy()}
    return out


def _mamba_norm(case, rules):
    """``_gated_norm`` of this rank's channels of the seeded ``y``, ``z``
    and ``scale`` with the line's sum of squares: its output and the
    gradients of ``sum(out * cot)`` over this rank's channels with respect
    to its ``y``, ``z`` and ``scale``."""
    from repro_torch.models.mamba2 import _gated_norm
    from repro_torch.models.tensor_parallel import tp_group
    from repro_torch.sharding import use_rules

    g = {k: torch.from_numpy(v) for k, v in case["inputs"].items()}
    with use_rules(rules):
        tp = tp_group()
        di = g["y"].shape[-1]
        n = di // tp.size
        mine = {k: g[k][..., tp.index * n:(tp.index + 1) * n]
                for k in ("y", "z", "scale", "cot")}
        leaves = {k: mine[k].clone().requires_grad_()
                  for k in ("y", "z", "scale")}
        out = _gated_norm(leaves["scale"], leaves["y"], leaves["z"],
                          case["eps"], tp, di)
        (out * mine["cot"]).sum().backward()
    return {"out": out.detach().numpy(),
            **{k: v.grad.numpy() for k, v in leaves.items()}}


def _restore(case, rules):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.store import _leaves
    from repro_torch.sharding.placement import global_params, named_shardings
    from repro_torch.train import init_train_state

    whole = init_train_state(case["cfg"],
                             global_params(case["cfg"], torch.float32))
    back = restore_checkpoint(case["ckpt_dir"], whole, step=case["step"],
                              device="cpu",
                              sharding_tree=named_shardings(whole, rules))
    return {k: v.numpy() for k, v in _leaves(back)}


def _stall(timeout_s):
    from repro_torch.core.collectives import mesh_comm
    from repro_torch.launch.mesh import make_local_mesh

    comm = mesh_comm(make_local_mesh(1, 2))
    if dist.get_rank() != 0:
        time.sleep(timeout_s + 2)        # alive, but never joins
        return ("skipped", 0.0)
    t0 = time.perf_counter()
    try:
        comm.exchange([torch.zeros(4), torch.zeros(4)], ("model",), "a2a")
    except Exception as e:  # the type is the result
        return (type(e).__name__, time.perf_counter() - t0)
    return (None, time.perf_counter() - t0)


def run_case(case, timeout_s):
    if case["kind"] == "stall":
        return _stall(timeout_s)
    rules = _rules(case)
    return {"moe": _moe, "serve": _serve, "train": _train,
            "thread_grad": _thread_grad,
            "fsdp_gather": _fsdp_gather, "fsdp_wire": _fsdp_wire,
            "restore": _restore, "tp_grads": _tp_grads,
            "mamba_norm": _mamba_norm,
            "step_counts": _step_counts}[case["kind"]](
                case, rules)


def _arrive(store, world):
    """Wait on ``store`` until all ``world`` ranks have started, bounded by
    :data:`ARRIVAL_TIMEOUT_S`: on a loaded host spawned ranks come seconds
    apart, and a group timeout (:func:`_stall`'s 3 s) must bound the
    group's waits, not the ranks' start."""
    store.set_timeout(datetime.timedelta(seconds=ARRIVAL_TIMEOUT_S))
    if store.add("arrived", 1) == world:
        store.set("all_arrived", "1")
    store.wait(["all_arrived"])


def main(rank, world, init_file, cases_file, queue,
         timeout_s=GROUP_TIMEOUT_S):
    """One rank: read the pickled cases from ``cases_file``; once every
    rank has started, join the gloo group through ``init_file`` (every
    wait of the group bounded by ``timeout_s``), run the cases, put
    ``(rank, "ok", results)`` (or ``(rank, "error", traceback)``) on
    ``queue``."""
    torch.set_num_threads(1)  # ranks share the host's cores
    try:
        with open(cases_file, "rb") as f:
            cases = pickle.load(f)
        store = dist.FileStore(init_file, world)
        _arrive(store, world)
        store.set_timeout(datetime.timedelta(seconds=timeout_s))
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        queue.put((rank, "ok", [run_case(c, timeout_s) for c in cases]))
    except Exception:  # report to the parent, whatever failed
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world, cases, timeout_s=GROUP_TIMEOUT_S, limit_s=150):
    """Run ``cases`` on ``world`` gloo ranks (``torch.multiprocessing``,
    spawned, a ``FileStore``): ``{rank: (status, payload)}``. Every
    process is joined, or killed past ``limit_s``. The cases travel in a
    file: a spawned process's arguments go through a pipe that the parent
    fills before it starts the next, so arguments larger than the pipe
    would start the ranks one after another."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        cases_file = os.path.join(tmp, "cases.pkl")
        with open(cases_file, "wb") as f:
            pickle.dump(cases, f)
        procs = [ctx.Process(target=main,
                             args=(r, world, init, cases_file, q, timeout_s),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + limit_s
        try:
            while len(got) < world and time.monotonic() < deadline:
                try:
                    rank, status, payload = q.get(timeout=1.0)
                except queues.Empty:
                    if all(p.exitcode is not None for p in procs):
                        break
                    continue
                got[rank] = (status, payload)
        finally:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    assert len(got) == world, (f"{world - len(got)} rank(s) reported "
                               f"nothing within {limit_s} s")
    return got
