"""Spawned gloo ranks for the port's multi-process tests (imports no jax:
every rank imports torch and the port only).

`run(fn, world, payload, tmp)` starts `world` processes with
`torch.multiprocessing` on a `file://` store under `tmp`, one torch thread
each; rank r calls `fn(rank, world, payload)` and its return value comes
back to the caller in rank order. A rank that raises fails the spawn and
the test. The rank functions live here, beside the helpers they share.
"""

from __future__ import annotations

import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from radvlm_tpu_torch.config import IMAGE_TOKEN_INDEX


def _entry(rank, world, init, fn, payload, out_dir):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        result = fn(rank, world, payload)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn, world: int, payload, tmp) -> list:
    out_dir = str(tmp)
    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(out_dir, "store")
    mp.spawn(_entry, args=(world, init, fn, payload, out_dir), nprocs=world, join=True)
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def samples(mm, cfg, lengths=(6, 11, 8)):
    """One image prompt per length (ids and a 90 x 70 image from a seed), as
    `mm.build_sample` makes them: the JAX package's and the port's
    `multimodal` give the same ids and tiles."""
    out = []
    for n in lengths:
        r = np.random.default_rng(n)
        img = r.integers(0, 255, size=(90, 70, 3), dtype=np.uint8)
        ids = list(r.integers(3, cfg.text.vocab_size, size=n))
        out.append(mm.build_sample(ids[:2] + [IMAGE_TOKEN_INDEX] + ids[2:], [img], cfg))
    return out


ENGINE = dict(num_slots=2, max_len=256, prompt_buckets=(128,), pad_tiles=2, attn_impl="xla")


def engine_tokens(model, cfg, gen, sample_list, **kw):
    from radvlm_tpu_torch.generation.continuous import ContinuousBatcher

    b = ContinuousBatcher(model, cfg, gen, **dict(ENGINE, **kw))
    reqs = [b.submit(s) for s in sample_list]
    done = {r.uid: r.emitted for r in b.run()}
    return [done[r.uid] for r in reqs], b


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------


def tp_engines(rank, world, payload):
    """The port's TP engine on every rank, once per run of `payload["runs"]`
    (name -> batcher and generation options), over the same requests."""
    from radvlm_tpu_torch.generation.engine import GenerationConfig
    from radvlm_tpu_torch.models import convert
    from radvlm_tpu_torch.models import multimodal as tmm
    from radvlm_tpu_torch.parallel import tp
    from radvlm_tpu_torch.parallel.mesh import make_mesh

    cfg, params = payload["cfg"], payload["params"]
    mesh = make_mesh({"tensor": world})
    out = {}
    for name, (engine_kw, gen_kw) in payload["runs"].items():
        model = convert.radvlm_from_jax(params, cfg, device="cpu")
        gen = GenerationConfig(eos_token_ids=(), **gen_kw)
        toks, b = engine_tokens(model, cfg, gen, samples(tmm, cfg, payload["lengths"]),
                                mesh=mesh, **engine_kw)
        out[name] = toks
        out[name + "_provenance"] = b.kernel_provenance()
        out[name + "_q_rows"] = tuple(b.model.text.layers[0].qkv.weight.shape)
        out[name + "_cache"] = tuple(b.cache[0].shape)
    # Outside an engine the context is off: no all_reduce leaks.
    out["context_after"] = tp.context()
    return out


def ring_cases(rank, world, payload):
    """Ring attention over the world on this rank's sequence block of each
    case's global q / k / v / segment ids."""
    from radvlm_tpu_torch.parallel import ring
    from radvlm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"seq": world})
    out = []
    for case in payload:
        s = case["q"].shape[1] // world
        own = slice(rank * s, (rank + 1) * s)
        q, k, v = (torch.from_numpy(case[n][:, own]) for n in ("q", "k", "v"))
        seg = case.get("seg")
        seg = None if seg is None else torch.from_numpy(seg[:, own])
        fn = ring.make_ring_attention(mesh, impl=case.get("impl", "flash"))
        out.append(fn(q, k, v, seg, seg).numpy())
    return out


def sp_generate(rank, world, payload):
    """For each batch: `make_sp_generate_fn` over the bf16 and the int8
    cache; the SP prefill's cache and logits against `engine.prefill`; and
    SP decode steps over the split cache against the plain cached step on
    the whole one (bf16 and int8)."""
    from radvlm_tpu_torch.generation import engine
    from radvlm_tpu_torch.generation.engine import GenerationConfig
    from radvlm_tpu_torch.models import convert
    from radvlm_tpu_torch.parallel.mesh import make_mesh
    from radvlm_tpu_torch.parallel.sp_decode import make_sp_decode_step

    cfg, params, new = payload["cfg"], payload["params"], payload["new"]
    mesh = make_mesh({"seq": world})
    model = convert.radvlm_from_jax(params, cfg, device="cpu")
    gen = GenerationConfig(max_new_tokens=new, eos_token_ids=())
    outs = []
    for host_batch in payload["batches"]:
        batch = {k: torch.from_numpy(v) for k, v in host_batch.items()}
        out = {}
        for kvq in (False, True):
            res = engine.make_sp_generate_fn(cfg, mesh, gen, kv_quant=kvq)(model, batch)
            out[f"tokens_{kvq}"] = res["tokens"].numpy()
            out[f"num_{kvq}"] = res["num_tokens"].numpy()
        b, l = batch["tokens"].shape
        max_len = l + payload["extra"]
        cache, seg, logits = engine.make_sp_prefill_fn(cfg, mesh)(model, batch, max_len)
        ref_cache, ref_seg, ref_logits = engine.prefill(model, cfg, batch, max_len,
                                                        attn_impl="xla")
        # Padding positions attend nothing: the ring writes 0 there, plain
        # attention the mean of v, so later layers' K/V differ there alone.
        # The cache is bf16: f32 sums in another order may round an entry
        # to its neighbour (one bf16 step, 2^-8 of its value).
        real = (ref_seg != 0)[None, :, :, None]
        out["prefill_cache_ok"] = all(
            bool((((a.float() - r.float()).abs() <= r.float().abs() * 2 ** -7 + 1e-6)
                  | ~real).all()) for a, r in zip(cache, ref_cache))
        out["prefill_logits_err"] = float((logits - ref_logits).abs().max())
        out["prefill_seg_equal"] = bool(torch.equal(seg, ref_seg))
        s_local = max_len // world
        own = slice(rank * s_local, (rank + 1) * s_local)
        for kvq in (False, True):
            full, fseg, lg = engine.prefill(model, cfg, batch, max_len, attn_impl="xla",
                                            cache_format="int8" if kvq else "bf16")
            local = tuple(c[:, :, own].clone() if i < 2 else c[..., own].clone()
                          for i, c in enumerate(full))
            lseg = fseg[:, own].clone()
            step = make_sp_decode_step(cfg.text, mesh, kv_quant=kvq)
            tok = lg.argmax(-1)
            errs, scale = [], []
            for i in range(new):
                pos = batch["lengths"] + i
                local, lseg, lg_sp = step(model.text, local, lseg, tok, pos, l + i)
                full, fseg, lg_ref = engine.decode_step(model, cfg, full, fseg, tok, pos, l + i,
                                                        attn_impl="xla")
                errs.append(float((lg_sp - lg_ref).abs().max()))
                scale.append(float(lg_ref.abs().max()))
                tok = lg_ref.argmax(-1)
            out[f"step_err_{kvq}"] = (max(errs), max(scale))
            out[f"seg_equal_{kvq}"] = bool(torch.equal(lseg, fseg[:, own]))
        outs.append(out)
    return outs


class ByteTokenizer:
    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [2 + b for b in text.encode()]

    def decode(self, ids):
        return bytes(min(255, i - 2) for i in ids if i >= 2).decode(errors="ignore")


def grounding_split(n: int, seed: int = 0) -> list:
    """An in-memory abnormality_grounding split: images of a few sizes and
    the adapter's keys."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = (90, 70) if i % 2 else (64, 96)
        out.append({
            "idx": i,
            "img": r.integers(0, 255, size=(h, w, 3), dtype=np.uint8),
            "instr": {"question": f"Where is the opacity {i}?", "answer": "[0.1, 0.2, 0.3, 0.4]"},
            "boxes": [[0.1, 0.2, 0.3, 0.4]],
            "label": "opacity",
        })
    return out


def run_task_ranks(rank, world, payload):
    """`run_task` over the world, once per mode of `payload["modes"]`:
    "split", each rank its share, gathered; "tp", the world one
    tensor-parallel engine (`VLMRunner(mesh=)`) over every sample. Rank 1
    builds its samples slower, so submits timed by the host (a feeder
    thread's) would reach the ranks' engine loops at different steps."""
    import time

    from radvlm_tpu_torch.eval import harness
    from radvlm_tpu_torch.eval.harness import VLMRunner, run_task
    from radvlm_tpu_torch.models import convert
    from radvlm_tpu_torch.parallel.mesh import make_mesh

    if rank == 1:
        build = harness.multimodal.build_sample

        def slow_build(*a, **kw):
            time.sleep(0.05)
            return build(*a, **kw)

        harness.multimodal.build_sample = slow_build
    cfg = payload["cfg"]
    out = {}
    for mode in payload["modes"]:
        model = convert.radvlm_from_jax(payload["params"], cfg, device="cpu")
        mesh = make_mesh({"tensor": world}) if mode == "tp" else None
        runner = VLMRunner(model=model, cfg=cfg, tokenizer=ByteTokenizer(), max_new_tokens=4,
                           batch_size=2, attn_impl="xla", mesh=mesh)
        out_dir = os.path.join(payload["out"], mode, f"rank{rank}")
        seen = []
        results, metrics = run_task(runner, grounding_split(payload["n"]),
                                    "abnormality_grounding", with_clinical=False,
                                    output_dir=out_dir,
                                    progress=lambda done, total: seen.append(total))
        out[mode] = dict(results=results, metrics=metrics, wrote=os.path.exists(out_dir),
                         share=seen[-1] if seen else 0)
    return out


# ---------------------------------------------------------------------------
# Training over a mesh (parallel/sharding.py, parallel/ring.py)
# ---------------------------------------------------------------------------


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def whole_tree(model, cfg):
    """The JAX-layout tree (numpy) of a model sharded over the mesh: every
    parameter gathered whole (`sharding.full_parameters`). Collective: every
    rank calls it."""
    from radvlm_tpu_torch.models import convert, radvlm
    from radvlm_tpu_torch.parallel import sharding

    full = radvlm.RadVLM(cfg, device="cpu", dtype=torch.float32)
    full.load_state_dict(sharding.full_parameters(model))
    return _numpy_tree(convert.radvlm_to_tree(full))


def _sft_case(case, cfg, params, batches):
    """One case's SFT (or LoRA) micro-steps over its mesh on this rank's part
    of every batch: (losses, grad norms, the trained tree or adapters)."""
    from radvlm_tpu_torch.eval.harness import batch_to_device
    from radvlm_tpu_torch.models import convert
    from radvlm_tpu_torch.parallel import ring, sharding
    from radvlm_tpu_torch.parallel.mesh import make_mesh
    from radvlm_tpu_torch.training import loop
    from radvlm_tpu_torch.training import optimizer as topt
    from radvlm_tpu_torch.training import train_step as tts
    from radvlm_tpu_torch.training.lora import LoraConfig, adapter_parameters

    mesh = make_mesh(case["shape"])
    model = convert.radvlm_from_jax(case.get("params") or params, cfg, device="cpu",
                                    dtype=torch.float32)
    attn = case.get("attn", "auto")
    if case.get("ring"):
        ring.enable_ring_attention(mesh, impl="flash", schedule=case["ring"])
        attn = "ring"
    train = topt.TrainConfig(**case["train"])
    lora = case.get("lora")
    try:
        if lora:
            adapters = {p: {k: torch.from_numpy(v.copy()).requires_grad_(True)
                            for k, v in ad.items()} for p, ad in case["adapters"].items()}
            state, base, step_fn = tts.setup_lora_training(
                cfg, train, LoraConfig(**lora), model, attn_impl=attn, adapters=adapters,
                mesh=mesh)
        else:
            state, step_fn, _ = tts.setup_training(cfg, train, model, attn_impl=attn, mesh=mesh)
        losses, norms = [], []
        for b in batches:
            b = batch_to_device(loop.rank_batch(b, state.mesh, attn), "cpu")
            state, m = (step_fn(state, base, b) if lora else step_fn(state, b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        ring.enable_ring_attention(None)
    if lora:
        out = {k: v.detach().numpy() for k, v in adapter_parameters(state.params).items()}
    else:
        out = whole_tree(model, cfg)
    return losses, norms, out


def sharded_sft(rank, world, payload):
    """Every case of `payload["cases"]` (its mesh `shape`, `train` options,
    optional `attn` impl or `ring` schedule, `lora` options with the
    starting `adapters`, its own `cfg`, `batches` and starting `params`)
    over the payload's starting parameters where the case has none."""
    import warnings

    warnings.filterwarnings("ignore", category=FutureWarning)
    return [_sft_case(case, case.get("cfg") or payload["cfg"], payload["params"],
                      case.get("batches") or payload["batches"])
            for case in payload["cases"]]


def sharded_resume(rank, world, payload):
    """Under the mesh `payload["shape"]`: N micro-steps straight, against
    N - 1 steps, a checkpoint, a fresh setup restored from it and one more
    step. Returns (the largest difference of the two runs' parameters, the
    files in the step directory)."""
    from radvlm_tpu_torch.eval.harness import batch_to_device
    from radvlm_tpu_torch.models import convert
    from radvlm_tpu_torch.parallel import sharding
    from radvlm_tpu_torch.parallel.mesh import make_mesh
    from radvlm_tpu_torch.training import checkpoint as ckpt
    from radvlm_tpu_torch.training import loop
    from radvlm_tpu_torch.training import optimizer as topt
    from radvlm_tpu_torch.training import train_step as tts

    cfg, params, batches = payload["cfg"], payload["params"], payload["batches"]
    mesh = make_mesh(payload["shape"])

    def run(bs, state=None):
        if state is None:
            model = convert.radvlm_from_jax(params, cfg, device="cpu", dtype=torch.float32)
            state, _, _ = tts.setup_training(cfg, topt.TrainConfig(**payload["train"]), model,
                                             mesh=mesh)
        step_fn = tts.make_train_step(cfg, state.opt_state)
        for b in bs:
            state, _ = step_fn(state, batch_to_device(loop.rank_batch(b, state.mesh, "auto"),
                                                      "cpu"))
        return state

    straight = run(batches)
    first = run(batches[:-1])
    manager = ckpt.CheckpointManager(payload["dir"], save_interval_steps=1)
    assert ckpt.save_state(manager, len(batches) - 1, first)
    fresh = run([])
    resumed = run(batches[-1:], ckpt.restore_state(manager, len(batches) - 1, fresh))
    a, b = sharding.full_parameters(straight.params), sharding.full_parameters(resumed.params)
    diff = max(float((a[k] - b[k]).abs().max()) for k in a)
    files = sorted(os.listdir(os.path.join(payload["dir"], f"step_{len(batches) - 1}")))
    return diff, files, resumed.step, resumed.opt_state.count, resumed.opt_state.mini_step


def mesh_preference(rank, world, payload):
    """DPO steps over `payload["dpo"]` pairs and GRPO updates over the
    `payload["grpo"]` wave, under the mesh `payload["shape"]`: each step's
    metrics and the trained tree."""
    import warnings

    from radvlm_tpu_torch.eval.harness import batch_to_device
    from radvlm_tpu_torch.models import convert
    from radvlm_tpu_torch.parallel.mesh import make_mesh
    from radvlm_tpu_torch.training import dpo, grpo, loop
    from radvlm_tpu_torch.training import optimizer as topt
    from radvlm_tpu_torch.training import train_step as tts

    warnings.filterwarnings("ignore", category=FutureWarning)
    cfg, params = payload["cfg"], payload["params"]
    out = {}
    for name in ("dpo", "grpo"):
        spec = payload[name]
        if spec is None:
            continue
        mesh = make_mesh(payload["shape"])
        model = convert.radvlm_from_jax(params, cfg, device="cpu", dtype=torch.float32)
        local_cfg, mg = tts.shard_model(cfg, topt.TrainConfig(**spec["train"]), model, mesh)
        opt = topt.make_optimizer(model, topt.TrainConfig(**spec["train"]))
        state = tts.TrainState(step=0, params=model, opt_state=opt, mesh=mg)
        ref = dpo.frozen_copy(model)
        metrics = []
        if name == "dpo":
            step_fn = dpo.make_dpo_step(local_cfg, dpo.DPOConfig(beta=0.1), opt)
            for c, r in spec["pairs"]:
                c, r = (batch_to_device(loop.rank_batch(x, mg, "auto"), "cpu") for x in (c, r))
                state, m = step_fn(state, ref, c, r)
                metrics.append({k: float(v) for k, v in m.items()})
        else:
            host = dict(spec["batch"], advantages=spec["adv"])
            b = batch_to_device(loop.rank_batch(host, mg, "auto"), "cpu")
            adv = b.pop("advantages")
            old = grpo.make_score_fn(local_cfg)(model, b)
            step_fn = grpo.make_grpo_step(local_cfg, grpo.GRPOConfig(**spec["gc"]), opt)
            for _ in range(2):
                state, m = step_fn(state, ref, b, adv, old)
                metrics.append({k: float(v) for k, v in m.items()})
        out[name] = (metrics, whole_tree(model, cfg))
    return out


class CliTok:
    eos_token_ids, pad_token_id = (1,), 0

    @staticmethod
    def encode(text):
        return [2 + b for b in text.encode()][:24]

    @staticmethod
    def decode(ids):
        return bytes(min(255, max(0, i - 2)) for i in ids if i >= 2).decode(errors="ignore")


def mesh_clis(rank, world, payload):
    """Each (module, argv) of `payload["runs"]` through its `main`, on this
    rank of the world: the final step, and the step directories' files."""
    import importlib
    import warnings

    warnings.filterwarnings("ignore", category=FutureWarning)
    out = []
    for module, argv, out_dir in payload["runs"]:
        state = importlib.import_module(module).main(argv, tokenizer=CliTok())
        dist.barrier()
        steps = sorted(d for d in os.listdir(out_dir) if d.startswith("step_"))
        out.append((int(state.step), steps,
                    sorted(os.listdir(os.path.join(out_dir, steps[-1]))) if steps else []))
    return out


def qgz(rank, world, payload):
    """`quantized_psum` over the world of each rank's row of every case."""
    from radvlm_tpu_torch.parallel.compression import quantized_pmean, quantized_psum

    out = []
    for x in payload:
        mine = torch.from_numpy(x[rank])
        out.append((quantized_psum(mine, block=64).numpy(),
                    quantized_pmean(mine, block=64).numpy()))
    return out


def ring_grads(rank, world, payload):
    """The zigzag (or contiguous) ring over the world on this rank's block of
    each case's global q / k / v / segment ids (in the schedule's layout):
    the output and, for the cotangent `do`, the gradients of q, k, v."""
    from radvlm_tpu_torch.parallel import ring
    from radvlm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"seq": world})
    out = []
    for case in payload:
        s = case["q"].shape[1] // world
        own = slice(rank * s, (rank + 1) * s)
        q, k, v = (torch.from_numpy(case[n][:, own]).requires_grad_(True) for n in "qkv")
        seg = torch.from_numpy(case["seg"][:, own])
        fn = ring.make_ring_attention(mesh, impl=case["impl"], schedule=case["schedule"])
        o = fn(q, k, v, seg, seg)
        (o * torch.from_numpy(case["do"][:, own])).sum().backward()
        out.append((o.detach().numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy()))
    return out


# ---------------------------------------------------------------------------
# Pipeline parallelism (parallel/pp.py) and the mesh configurations
# ---------------------------------------------------------------------------


def _torch_adapters(ads):
    return {p: {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in ad.items()}
            for p, ad in ads.items()}


def _pp_case(case, payload):
    """One case of `pp_cases` on this rank: its kind's results."""
    from radvlm_tpu_torch.eval.harness import batch_to_device
    from radvlm_tpu_torch.models import convert, resampler
    from radvlm_tpu_torch.parallel import pp
    from radvlm_tpu_torch.parallel.mesh import make_mesh
    from radvlm_tpu_torch.training import loop
    from radvlm_tpu_torch.training import optimizer as topt
    from radvlm_tpu_torch.training.lora import LoraConfig, adapter_parameters

    kind = case["kind"]
    if kind == "cli":
        import dataclasses
        import importlib

        from radvlm_tpu_torch import config

        # `--model-size tiny` with `layers` decoder layers (4: stage 2 x V 2).
        tiny = config.tiny_test_config
        config.tiny_test_config = lambda: dataclasses.replace(tiny(), text=dataclasses.replace(
            tiny().text, num_layers=case["layers"]))
        try:
            state = importlib.import_module("radvlm_tpu_torch.training.cli").main(
                case["argv"], tokenizer=CliTok())
        finally:
            config.tiny_test_config = tiny
        dist.barrier()
        return int(state.step), sorted(d for d in os.listdir(case["out"]) if d.startswith("step_"))
    cfg = case.get("cfg") or payload["cfg"]
    mesh = make_mesh(case["shape"])
    model = convert.radvlm_from_jax(case.get("params") or payload["params"], cfg, device="cpu",
                                    dtype=torch.float32)
    v, m = case.get("interleave", 1), case.get("micro", 2)
    batches = case.get("batches") or payload["batches"]
    if kind in ("grads", "masked_drop", "invariant"):
        for p in model.parameters():
            p.requires_grad_(True)
        mg = pp.hold_stage(model, cfg, mesh, interleave=v, n_microbatches=m)
        b = batch_to_device(loop.rank_batch(batches[0], mg, "xla"), "cpu")

        def run(micro, gen=None):
            fn = pp.make_pp_grad_fn(mesh, cfg, n_microbatches=micro, remat=case.get("remat", True),
                                    attn_impl="xla", interleave=v)
            return fn(model, b, gen)

        if kind == "grads":
            grads, met = run(m)
            return float(met["loss"]), float(met["tokens"]), {
                k: g.numpy() for k, g in grads.items()}
        if kind == "invariant":
            return [float(run(micro)[1]["loss"]) for micro in case["counts"]]
        draw = resampler.draw_uniform
        resampler.draw_uniform = lambda gen, shape, device: torch.from_numpy(case["u"])
        try:
            injected = float(run(m, torch.Generator().manual_seed(0))[1]["loss"])
        finally:
            resampler.draw_uniform = draw
        return injected, [float(run(m, torch.Generator().manual_seed(s))[1]["loss"])
                          for s in (1, 1, 2)]
    train = topt.TrainConfig(**case["train"])
    pp_cfg = pp.PPStepConfig(n_microbatches=m, remat=case.get("remat", True), attn_impl="xla",
                             interleave=v)
    if kind == "step":
        state, step_fn, _ = pp.setup_pp_training(mesh, cfg, train, model, pp_cfg=pp_cfg)
    else:  # "lora"
        lcfg = LoraConfig(**case["lora"])
        state, base, step_fn = pp.setup_pp_lora_training(
            mesh, cfg, train, lcfg, model, pp_cfg=pp_cfg,
            adapters=_torch_adapters(case["adapters"]))
        grad_fn = pp.make_pp_lora_grad_fn(mesh, cfg, lcfg, n_microbatches=m,
                                          remat=pp_cfg.remat, attn_impl="xla", interleave=v)
        grads, _ = grad_fn(state.params, base,
                           batch_to_device(loop.rank_batch(batches[0], state.mesh, "xla"), "cpu"))
        grad_norm = float(torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values())))
    losses, norms = [], []
    for hb in batches:
        b = batch_to_device(loop.rank_batch(hb, state.mesh, "xla"), "cpu")
        state, met = step_fn(state, base, b) if kind == "lora" else step_fn(state, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    if kind == "lora":
        held = {k: t.detach().numpy() for k, t in adapter_parameters(state.params).items()}
        return losses, norms, held, grad_norm
    else:
        held = {k: p.detach().numpy() for k, p in model.named_parameters()}
    return losses, norms, held


def pp_cases(rank, world, payload):
    """Every case of `payload["cases"]` on one spawned world, by `kind`:
    "grads" (the PP loss and this rank's summed gradients), "masked_drop"
    (the loss under an injected uniform draw, then under generators seeded
    1, 1, 2), "invariant" (the loss at each microbatch count), "step" and
    "lora" (PP train steps: losses, grad norms, the parameters or adapters
    this rank holds; for "lora" also the global norm of
    `make_pp_lora_grad_fn`'s gradients before the first step), "cli" (the
    training CLI: the final step and the step directories)."""
    import warnings

    warnings.filterwarnings("ignore", category=FutureWarning)
    return [_pp_case(case, payload) for case in payload["cases"]]


def _train_under(shape, cfg, params, train, batches, interleave=1):
    """A fresh model trained over `batches` under the mesh `shape` (None:
    one process; a stage axis: the pipeline); returns the state."""
    from radvlm_tpu_torch.eval.harness import batch_to_device
    from radvlm_tpu_torch.models import convert
    from radvlm_tpu_torch.parallel import pp
    from radvlm_tpu_torch.parallel.mesh import make_mesh
    from radvlm_tpu_torch.training import loop
    from radvlm_tpu_torch.training import optimizer as topt
    from radvlm_tpu_torch.training import train_step as tts

    model = convert.radvlm_from_jax(params, cfg, device="cpu", dtype=torch.float32)
    mesh = None if shape is None else make_mesh(shape)
    train = topt.TrainConfig(**train)
    if shape is not None and shape.get("stage", 1) > 1:
        state, step_fn, _ = pp.setup_pp_training(
            mesh, cfg, train, model,
            pp_cfg=pp.PPStepConfig(n_microbatches=2, attn_impl="xla", interleave=interleave))
    else:
        state, step_fn, _ = tts.setup_training(cfg, train, model, attn_impl="xla", mesh=mesh)
    for hb in batches:
        b = hb if state.mesh is None else loop.rank_batch(hb, state.mesh, "xla")
        state, _ = step_fn(state, batch_to_device(b, "cpu"))
    return state


def sft_and_checkpoints(rank, world, payload):
    """`sharded_sft` over `payload["sft"]`, then `mesh_checkpoints` over
    `payload["checkpoints"]`, in one spawned world."""
    return (sharded_sft(rank, world, payload["sft"]),
            mesh_checkpoints(rank, world, payload["checkpoints"]))


def mesh_checkpoints(rank, world, payload):
    """For each saving mesh of `payload["saves"]` (name -> shape): train the
    payload's batches under it and save the step into `<dir>/<name>`; then
    restore every saved step under each of `payload["restores"]` (label ->
    shape and interleave; saved again into `<dir>/<name>_<label>`) and on
    one process. Returns, per name, the one-process state: {"params", "mu",
    "nu"} by parameter name, and the optimizer's count and step."""
    from radvlm_tpu_torch.training import checkpoint as ckpt

    cfg, params, train, batches = (payload[k] for k in ("cfg", "params", "train", "batches"))
    out = {}
    for name, shape in payload["saves"].items():
        state = _train_under(shape, cfg, params, train, batches)
        assert ckpt.save_state(ckpt.CheckpointManager(os.path.join(payload["dir"], name)),
                               len(batches), state, force=True)
    for name in payload["saves"]:
        manager = ckpt.CheckpointManager(os.path.join(payload["dir"], name))
        for label, (shape, interleave) in payload["restores"].items():
            state = _train_under(shape, cfg, params, train, [], interleave)
            state = ckpt.restore_state(manager, len(batches), state)
            again = ckpt.CheckpointManager(os.path.join(payload["dir"], f"{name}_{label}"))
            assert ckpt.save_state(again, len(batches), state, force=True)
        one = ckpt.restore_state(manager, len(batches), _train_under(None, cfg, params, train, []))
        opt = one.opt_state
        out[name] = dict(params={n: p.detach().numpy() for n, p in one.params.named_parameters()},
                         mu={n: t.numpy() for n, t in opt.mu.items()},
                         nu={n: t.numpy() for n, t in opt.nu.items()},
                         count=opt.count, step=one.step)
    return out


def pp_hop_cuda(rank, world, payload):
    """`pp._hop` around the ring of the world on CUDA tensors (gloo: through
    host memory): (what arrived, the gradient that came back, the
    transport)."""
    from radvlm_tpu_torch.parallel import pp

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    group = dist.group.WORLD
    x = torch.full((4, 8), float(rank + 1), device=dev, requires_grad=True)
    y = pp._hop(group, x, True)
    (y * float(rank + 2)).sum().backward()
    return y.detach().cpu().numpy(), x.grad.cpu().numpy(), pp.hop_transport(group, dev)
