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
