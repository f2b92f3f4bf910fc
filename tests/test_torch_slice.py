"""The port's serving slice end to end against the JAX package at the tiny
config: host prep (bit for bit), `VLMRunner.generate_batch` and
`ModelWorker.generate_stream` (identical greedy tokens and text), an HTTP
round trip to the port's worker, and a run of the port with jax blocked.
"""

import base64
import io
import json
import os
import subprocess
import sys
import textwrap
import urllib.request

import jax
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.eval.harness import VLMRunner as JRunner
from radvlm_tpu.models import anyres as janyres
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import image_ops as jimg
from radvlm_tpu.serve.worker import ModelWorker as JWorker
from radvlm_tpu_torch.eval.harness import VLMRunner as TRunner
from radvlm_tpu_torch.models import anyres as tanyres
from radvlm_tpu_torch.models import convert
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.ops import image_ops as timg
from radvlm_tpu_torch.serve.worker import ModelWorker as TWorker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ByteTokenizer:
    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [2 + b for b in text.encode()]

    def decode(self, ids):
        return bytes(min(255, i - 2) for i in ids if i >= 2).decode(errors="ignore")


def _images(rng):
    return [rng.integers(0, 255, (90, 70, 3), dtype=np.uint8),
            rng.integers(0, 255, (60, 130, 3), dtype=np.uint8)]


PROMPTS = ["<|im_start|>user\n<image>\nDescribe.<|im_end|>\n<|im_start|>assistant\n",
           "<|im_start|>user\nHello <image>\nFind the lesion in this study, "
           "please.<|im_end|>\n<|im_start|>assistant\n"]


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_test_config(vocab_size=300)
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(0)))
    return cfg, params


@pytest.mark.parametrize("size", [(90, 70), (60, 130), (56, 56), (400, 35)])
def test_host_tiles_and_plans_bit_exact(rng, size):
    cfg = cfglib.tiny_test_config()
    img = rng.integers(0, 255, size + (3,), dtype=np.uint8)
    for fn in ("preprocess_anyres_host", "preprocess_single_host"):
        (jt, js), (tt, ts) = (getattr(m, fn)(img, cfg.anyres) for m in (jimg, timg))
        assert js == ts and jt.dtype == tt.dtype
        np.testing.assert_array_equal(tt, jt)
    wh = (size[1], size[0])
    jp = janyres.compute_merge_plan(wh, cfg.anyres, 4)
    tp = tanyres.compute_merge_plan(wh, cfg.anyres, 4)
    assert (jp.length, jp.num_tiles, jp.grid) == (tp.length, tp.num_tiles, tp.grid)
    for a, b in zip(janyres.batch_plans([jp, jp]), tanyres.batch_plans([tp, tp])):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("left_pad", [True, False])
def test_collate_arrays_bit_exact(rng, tiny, left_pad):
    cfg, _ = tiny
    tok = ByteTokenizer()
    imgs = _images(rng)
    batches = []
    for mm in (jmm, tmm):
        samples = [mm.build_sample(mm.tokenize_with_images(tok.encode, p), [im], cfg)
                   for p, im in zip(PROMPTS, imgs)]
        batches.append(mm.collate(samples, pad_to_multiple=64, left_pad=left_pad))
    jb, tb = batches
    assert jb.keys() == tb.keys()
    for k in jb:
        assert jb[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_normalize_tiles_device_matches_jax(rng):
    tiles = rng.integers(0, 255, (2, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        timg.normalize_tiles_device(torch.from_numpy(tiles)).numpy(),
        np.asarray(jimg.normalize_tiles_device(jax.numpy.asarray(tiles))),
    )


def _runners(tiny, **kw):
    cfg, params = tiny
    common = dict(cfg=cfg, tokenizer=ByteTokenizer(), max_new_tokens=16, pad_to_multiple=64, **kw)
    return (JRunner(params=params, **common),
            TRunner(model=convert.radvlm_from_jax(params, cfg, device="cpu"), **common))


def test_generate_batch_tokens_identical(rng, tiny):
    """Two left-padded multimodal prompts of different lengths, greedy."""
    jr, tr = _runners(tiny, batch_size=2)
    imgs = [[im] for im in _images(rng)]
    expected = jr.generate_batch(PROMPTS, imgs)
    got = tr.generate_batch(PROMPTS, imgs)
    assert got == expected
    assert all(len(t) > 0 for t in got)


def _b64_png(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_generate_stream_text_identical(rng, tiny):
    jr, tr = _runners(tiny, batch_size=1)
    req = {"prompt": PROMPTS[1], "images": [_b64_png(_images(rng)[1])], "max_new_tokens": 12}
    expected = list(JWorker(jr, model_names=["tiny"]).generate_stream(req))
    got = list(TWorker(tr, model_names=["tiny"]).generate_stream(req))
    assert got == expected
    assert got and got[-1]["error_code"] == 0


def test_http_round_trip(rng, tiny):
    _, tr = _runners(tiny, batch_size=1)
    worker = TWorker(tr, model_names=["tiny"])
    port = worker.serve_forever(host="127.0.0.1", port=0, background=True)
    try:
        body = json.dumps({"prompt": PROMPTS[0], "images": [_b64_png(_images(rng)[0])],
                           "max_new_tokens": 5}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/worker_generate_stream", data=body)
        with urllib.request.urlopen(req, timeout=60) as resp:
            chunks = [json.loads(c) for c in resp.read().split(b"\0") if c]
        assert chunks and all(c["error_code"] == 0 for c in chunks)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/worker_get_status", data=b"{}")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read())["model_names"] == ["tiny"]
    finally:
        worker.shutdown()


def test_port_runs_with_jax_blocked():
    """The port imports no jax and nothing of the JAX package: with both
    `jax` and `radvlm_tpu` blocked in sys.modules (`sys.modules[name] = None`
    makes any import of it raise), every module imports, the tiny model
    generates tokens, the int8 continuous engine serves requests, with
    speculative decoding too, an int4 model saved as an artifact loads
    back and serves the same tokens, the trainer takes a full-finetune
    step and two QLoRA steps (optax, orbax and flax blocked too), and
    evaluation runs `run_task` on a classification and a grounding split
    and `eval.cli` on a saved int8 artifact (pandas and sklearn blocked
    too), and a tiny Llama judge serves `green_cli.main` through
    `TextLMEngine`, and through the int8 `LocalTorchClient` drives
    `filter_reports` and judges `evaluate_conversations`, and `dpo_cli` and
    `grpo_cli` each take a step, and the serving front answers a chat turn
    from the web UI through the controller and a worker, and the report
    metrics score with the port's own ROUGE (requests, rouge_score and nltk
    blocked too), and a tiny MoE and a tiny MPT model run forward, the MoE
    one is exported in the HF layout and `convert_cli` converts a training
    checkpoint, and every tower kind (CLIP with S2, EVA, ImageBind) and
    every resampler run a tiny model's forward, each tower importer (CLIP,
    open_clip, ImageBind, EVA) and the Q-Former's fills a module that runs,
    and the tower dispatch and `with_tower` answer, and M12's serving
    layouts run: a TP engine on two spawned gloo ranks, and in a world of
    one the mesh, ring attention, SP generation, fleets behind
    `FleetEngine`, `BatchWorker` and `run_task`, `eval.cli --multihost
    --fleet`, and M12's training half: a ZeRO-3 step through the zigzag
    ring (`parallel.sharding`, the zigzag helpers), qgZ's
    `parallel.compression`, and a pipeline's gradients on two spawned
    ranks (`parallel.pp`), and a fleet of TP engines refuses a world of one
    naming torchrun, and data preparation runs (the exporters,
    `create_exports`, `create_llava_dataset`, `synth_cli` with the fake
    client, both preprocessors), and the C++ tiler and decoder build and
    serve their routes."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["radvlm_tpu"] = None
        for name in ("optax", "orbax", "flax", "pandas", "sklearn", "requests", "rouge_score",
                     "nltk"):
            sys.modules[name] = None
        import importlib, pkgutil
        import numpy as np, torch
        torch.set_num_threads(1)  # one thread: the suite runs its test workers beside it
        import radvlm_tpu_torch
        for m in pkgutil.walk_packages(radvlm_tpu_torch.__path__, "radvlm_tpu_torch."):
            importlib.import_module(m.name)
        from radvlm_tpu_torch.config import tiny_test_config
        from radvlm_tpu_torch.eval.harness import VLMRunner
        from radvlm_tpu_torch.models.convert import init_params

        class Tok:
            eos_token_ids, pad_token_id = (1,), 0
            encode = staticmethod(lambda s: [2 + b for b in s.encode()])
            decode = staticmethod(lambda ids: str(list(ids)))

        cfg = tiny_test_config(vocab_size=300)
        model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                            dtype=torch.float32)
        runner = VLMRunner(model=model, cfg=cfg, tokenizer=Tok(), max_new_tokens=4,
                           batch_size=1, pad_to_multiple=64)
        img = np.random.default_rng(0).integers(0, 255, (70, 90, 3), dtype=np.uint8)
        # The int8 continuous path: int8 weights made by the port, the int8 cache.
        from radvlm_tpu_torch.generation.continuous import ContinuousBatcher
        from radvlm_tpu_torch.generation.engine import GenerationConfig
        from radvlm_tpu_torch.models import multimodal
        from radvlm_tpu_torch.models.convert import random_quantized_params
        qmodel = random_quantized_params(cfg, torch.Generator().manual_seed(0),
                                         device="cpu", dtype=torch.float32)
        batcher = ContinuousBatcher(qmodel, cfg, GenerationConfig(max_new_tokens=3),
                                    num_slots=2, max_len=256, prompt_buckets=(128,),
                                    pad_tiles=2, kv_quant=True)
        sample = multimodal.build_sample(Tok.encode("hi") + [-200], [img], cfg)
        reqs = [batcher.submit(sample) for _ in range(3)]
        assert [len(r.emitted) for r in batcher.run()] == [3, 3, 3]
        plain = [r.emitted for r in reqs]
        batcher = ContinuousBatcher(qmodel, cfg, GenerationConfig(max_new_tokens=3),
                                    num_slots=2, max_len=256, prompt_buckets=(128,),
                                    pad_tiles=2, kv_quant=True, spec_k=2)
        reqs = [batcher.submit(sample) for _ in range(3)]
        list(batcher.run())
        assert [r.emitted for r in reqs] == plain
        # The int4 path: an unfused int4 model at a width that divides by 128,
        # saved as an artifact, loaded back, served by the int4 engine.
        import dataclasses, tempfile
        from radvlm_tpu_torch.models import quant_io
        from radvlm_tpu_torch.models.layers import Q4Linear
        wide = dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, hidden_size=128, intermediate_size=256,
                                          head_dim=32),
            vision=dataclasses.replace(cfg.vision, hidden_size=128))
        q4 = random_quantized_params(wide, torch.Generator().manual_seed(1), device="cpu",
                                     dtype=torch.float32, bits=4, fuse=False)
        with tempfile.TemporaryDirectory() as d:
            quant_io.save_quantized(q4, wide, d)
            loaded_model, loaded_cfg = quant_io.load_quantized(d, device="cpu")
        assert loaded_cfg == wide and isinstance(loaded_model.text.layers[0].down, Q4Linear)
        sample4 = multimodal.build_sample(Tok.encode("hi") + [-200], [img], wide)
        outs = []
        for m in (q4, loaded_model):
            VLMRunner(model=m, cfg=wide, tokenizer=Tok())  # fuses in place
            b4 = ContinuousBatcher(m, wide, GenerationConfig(max_new_tokens=3), num_slots=2,
                                   max_len=256, prompt_buckets=(128,), pad_tiles=2,
                                   kv_quant=True)
            assert b4.kernel_provenance()["decode_matmul"] == "int4"
            r4 = [b4.submit(sample4) for _ in range(2)]
            list(b4.run())
            outs.append([r.emitted for r in r4])
        assert outs[0] == outs[1] and len(outs[0][0]) == 3
        # The training path: a full-finetune step and a QLoRA step.
        from radvlm_tpu_torch.eval.harness import batch_to_device
        from radvlm_tpu_torch.training import train_step as ts
        from radvlm_tpu_torch.training.lora import LoraConfig
        from radvlm_tpu_torch.training.optimizer import TrainConfig
        ids = Tok.encode("hi") + [-200] + Tok.encode("ok")
        train_sample = multimodal.build_sample(ids, [img], cfg, labels=[-100] * 3 + ids[3:])
        batch = batch_to_device(multimodal.collate(
            [multimodal.pack_samples([train_sample, train_sample])]), "cpu")
        tcfg = TrainConfig(grad_accum_steps=1, warmup_ratio=0.0, learning_rate=1e-3)
        fresh = init_params(cfg, torch.Generator().manual_seed(2), device="cpu",
                            dtype=torch.float32)
        w0 = fresh.text.layers[0].q.weight.detach().clone()
        state, step_fn, _ = ts.setup_training(cfg, tcfg, fresh)
        state, metrics = step_fn(state, batch)
        metrics_first = float(metrics["loss"])
        assert state.step == 1 and float(metrics["loss"]) > 0 and float(metrics["grad_norm"]) > 0
        assert not torch.equal(fresh.text.layers[0].q.weight, w0)
        qbase = random_quantized_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                        dtype=torch.float32, fuse=False)
        lstate, qbase, lstep = ts.setup_lora_training(cfg, tcfg, LoraConfig(rank=2), qbase)
        for _ in range(2):  # B starts at 0: A moves from the second step on
            lstate, metrics = lstep(lstate, qbase, batch)
        assert all(float(ad["b"].detach().abs().max()) > 0 for ad in lstate.params.values())
        # Evaluation: a MIMIC-CXR and a VinDr-CXR split written with csv and
        # PIL, run_task on the int8 continuous engine, eval.cli on an artifact.
        import csv, os
        from PIL import Image
        from radvlm_tpu_torch.eval import cli as eval_cli
        from radvlm_tpu_torch.eval.harness import build_task_dataset, run_task

        def write(path, rows):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w", newline="") as f:
                csv.writer(f).writerows(rows)

        def jpg(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(img[:40, :36]).save(path)

        data = tempfile.mkdtemp()
        mimic, vindr = f"{data}/MIMIC-CXR-JPG", f"{data}/VinDr-CXR"
        dicoms = [("d1", 10000001, 501, "PA"), ("d2", 10000002, 502, "AP"),
                  ("d3", 10000003, 503, "LATERAL")]
        write(f"{mimic}/mimic-cxr-2.0.0-metadata.csv", [["dicom_id", "subject_id", "study_id",
              "ViewPosition"]] + [list(d) for d in dicoms])
        write(f"{mimic}/mimic-cxr-2.0.0-split.csv", [["dicom_id", "subject_id", "study_id",
              "split"]] + [[d, s, st, "test"] for d, s, st, _ in dicoms])
        write(f"{mimic}/mimic-cxr-2.0.0-chexpert.csv", [["subject_id", "study_id",
              "Cardiomegaly", "Edema"], [10000001, 501, 1.0, ""], [10000002, 502, -1.0, 1.0]])
        write(f"{mimic}/reports.csv", [["study", "findings", "impression", "last_paragraph"]]
              + [[f"s{st}", "Heart size normal.", "", ""] for _, _, st, _ in dicoms])
        for d, s, st, _ in dicoms:
            jpg(f"{mimic}/files/p{str(s)[:2]}/p{s}/s{st}/{d}.jpg")
        write(f"{vindr}/annotations/annotations_test.csv",
              [["image_id", "class_name", "rad_id", "x_min", "y_min", "x_max", "y_max"],
               ["a", "Cardiomegaly", "R1", 100, 100, 400, 400],
               ["a", "Cardiomegaly", "R2", 110, 100, 410, 400],
               ["b", "Nodule/Mass", "R1", 500, 600, 800, 900]])
        with open(f"{vindr}/annotations/image_resolutions_test.json", "w") as f:
            f.write('{"a": [1000, 1000], "b": [1000, 1200]}')
        for i in "ab":
            jpg(f"{vindr}/test_jpg/{i}.jpg")
        qrunner = VLMRunner(model=random_quantized_params(cfg, torch.Generator().manual_seed(4),
                                                          device="cpu", dtype=torch.float32,
                                                          fuse=False),
                            cfg=cfg, tokenizer=Tok(), max_new_tokens=3, batch_size=2,
                            kv_quant=True)
        for task, n in (("abnormality_classification", 2), ("abnormality_grounding", 2)):
            results, metrics = run_task(qrunner, build_task_dataset(task, data), task,
                                        output_dir=f"{data}/out", with_clinical=False)
            assert len(results) == n and metrics, (task, results, metrics)
        art = f"{data}/artifact"
        quant_io.save_quantized(random_quantized_params(
            cfg, torch.Generator().manual_seed(5), device="cpu", dtype=torch.float32,
            fuse=False), cfg, art)
        metrics = eval_cli.main(["--task", "abnormality_grounding", "--checkpoint", art,
                                 "--data-dir", data, "--output-dir", f"{data}/cli",
                                 "--max-new-tokens", "3", "--batch-size", "2", "--device",
                                 "cpu"], tokenizer=Tok())
        assert os.path.exists(f"{data}/cli/radvlm_abnormality_grounding.json")
        assert "mAP_0.5" in metrics
        # Text-LM serving and the LLM-judged evaluation: a tiny Llama written
        # by the port's safetensors writer, the GREEN CLI on TextLMEngine, the
        # int8 local client driving filter_reports and judging a conversation.
        import json
        from radvlm_tpu_torch.data.llm_clients import LocalTorchClient
        from radvlm_tpu_torch.data.synth import filter_reports
        from radvlm_tpu_torch.eval import green_cli
        from radvlm_tpu_torch.eval.conversations import evaluate_conversations
        from radvlm_tpu_torch.models.safetensors_io import write_file

        class HFTok:  # the methods TextLMEngine calls on an HF tokenizer
            eos_token_id, pad_token_id, unk_token_id = 1, 0, None

            def __call__(self, text, add_special_tokens=True):
                return type("Encoding", (), {"input_ids": Tok.encode(text)})()

            def decode(self, ids, skip_special_tokens=True):
                return "".join(chr(0x100 + i) for i in ids)

            def convert_tokens_to_ids(self, token):
                return None

        lm = f"{data}/llama"
        os.makedirs(lm)
        g = torch.Generator().manual_seed(6)
        d, f, v = 32, 64, 300
        shapes = {"model.embed_tokens.weight": (v, d), "model.norm.weight": (d,),
                  "lm_head.weight": (v, d)}
        for i in range(2):
            p = f"model.layers.{i}."
            shapes.update({p + "input_layernorm.weight": (d,),
                           p + "post_attention_layernorm.weight": (d,),
                           p + "mlp.gate_proj.weight": (f, d), p + "mlp.up_proj.weight": (f, d),
                           p + "mlp.down_proj.weight": (d, f)})
            shapes.update({p + f"self_attn.{n}_proj.weight": (d, d) for n in "qkvo"})
        write_file({k: torch.randn(s, generator=g) * 0.1 for k, s in shapes.items()},
                   f"{lm}/model.safetensors")
        with open(f"{lm}/config.json", "w") as fh:
            json.dump({"model_type": "llama", "vocab_size": v, "hidden_size": d,
                       "intermediate_size": f, "num_hidden_layers": 2,
                       "num_attention_heads": 4, "num_key_value_heads": 4,
                       "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
                       "max_position_embeddings": 4096, "tie_word_embeddings": False}, fh)
        with open(f"{data}/outputs.json", "w") as fh:
            json.dump([{"txt": "No acute findings.", "output": "Normal chest."}], fh)
        mean, scores = green_cli.main(["--outputs", f"{data}/outputs.json", "--judge-model", lm,
                                       "--judge-slots", "2", "--device", "cpu"],
                                      tokenizer=HFTok())
        assert len(scores) == 1
        client = LocalTorchClient(lm, template="llama_2", max_tokens=4, num_slots=2,
                                  int8=True, device="cpu", tokenizer=HFTok())
        calls = []

        class Judge:
            def complete(self, prompt):
                calls.append(prompt)
                return client.complete(prompt)

        try:
            reports = [{"study_id": f"s{i}", "txt": f"Report {i}."} for i in range(3)]
            assert filter_reports(reports, client, f"{data}/filtered", num_workers=3) == 3
            convs = [{"img": img, "conversation": [{"from": "human", "value": "Effusion?"},
                                                   {"from": "gpt", "value": "No."}]}]
            res = evaluate_conversations(runner, convs, Judge(), output_path=f"{data}/conv.json")
        finally:
            client.shutdown()
        assert len(calls) == 1 and set(res) == {"mean_score", "n"}
        assert os.path.exists(f"{data}/conv.json")
        # Preference and RL finetuning through their CLIs: DPO on a
        # preference json, GRPO on a GRPO-REC jsonl (engine rollouts).
        from radvlm_tpu_torch.training import dpo_cli, grpo_cli
        Image.fromarray(img).save(f"{data}/cxr.png")
        with open(f"{data}/prefs.json", "w") as fh:
            json.dump([{"image": "cxr.png", "prompt": "<image>\\nAny effusion?",
                        "chosen": "Small left effusion.", "rejected": "Normal."}] * 2, fh)
        with open(f"{data}/rec.jsonl", "w") as fh:
            fh.write(json.dumps({"image": "cxr.png", "problem": "<image>find the heart",
                                 "solution": '{"bbox": [[0.1, 0.2, 0.5, 0.6]]}'}) + "\\n")
        common = ["--model-size", "tiny", "--image-folder", data, "--device", "cpu",
                  "--max-steps", "1", "--warmup-ratio", "0"]
        state = dpo_cli.main(common + ["--data-path", f"{data}/prefs.json", "--output-dir",
                                       f"{data}/dpo", "--micro-batch-size", "2"], tokenizer=Tok())
        assert state.step == 1
        state = grpo_cli.main(common + ["--data-path", f"{data}/rec.jsonl", "--output-dir",
                                        f"{data}/grpo", "--group-size", "2",
                                        "--prompts-per-wave", "1", "--max-new-tokens", "2",
                                        "--num-slots", "2", "--rollout-max-len", "256",
                                        "--prompt-bucket", "128", "--pad-tiles", "2"],
                              tokenizer=Tok())
        assert state.step == 1
        # The serving front: a registry dispatch, then the web UI over the
        # controller and a ModelWorker for one chat turn; the report metrics.
        import base64, io, threading, urllib.request
        from http.server import ThreadingHTTPServer
        from radvlm_tpu_torch.eval.metrics import evaluate_reports
        from radvlm_tpu_torch.serve.controller import Controller, Registry
        from radvlm_tpu_torch.serve.web import WebApp, make_handler
        from radvlm_tpu_torch.serve.worker import ModelWorker
        reg = Registry()
        reg.register("http://w", ["m"])
        assert reg.get_worker_address("m") == "http://w"
        ctl = Controller(host="127.0.0.1", port=0)
        ctl.serve_forever(background=True)
        worker = ModelWorker(runner, model_names=["tiny"],
                             controller_address=f"http://127.0.0.1:{ctl.port}")
        worker.serve_forever(host="127.0.0.1", port=0, background=True)
        web = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(
            WebApp(f"http://127.0.0.1:{ctl.port}", log_dir=f"{data}/logs")))
        threading.Thread(target=web.serve_forever, daemon=True).start()

        def post(path, obj):
            req = urllib.request.Request(f"http://127.0.0.1:{web.server_address[1]}{path}",
                                         data=json.dumps(obj).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.read()

        try:
            new = json.loads(post("/api/new", {}))
            assert new["models"] == ["tiny"]
            png = io.BytesIO()
            Image.fromarray(img).save(png, format="PNG")
            raw = post("/api/chat", {"session_id": new["session_id"], "model": "tiny",
                                     "text": "hi", "max_new_tokens": 2,
                                     "images": [base64.b64encode(png.getvalue()).decode()]})
            chunks = [json.loads(m) for m in raw.split(b"\\0") if m]
            assert chunks and all(c["error_code"] == 0 for c in chunks), chunks
        finally:
            web.shutdown()
            web.server_close()
            worker.shutdown()
            ctl.shutdown()
        metrics = evaluate_reports(["No acute process.", "Small left pleural effusion."],
                                   ["No acute findings.", "Left pleural effusions."],
                                   with_clinical=False)
        assert 0 < metrics["rougel"] < 1 and metrics["rouge1"] > 0, metrics
        # The decoder families: a tiny Mixtral-style MoE and a tiny MPT
        # forward; the HF export of the first (and MPT's own layout), and
        # convert_cli on a checkpoint the trainer's checkpoint module saved.
        from radvlm_tpu_torch.config import tiny_test_config as tiny_cfg
        from radvlm_tpu_torch.models import convert_cli, hf_export, hf_import
        from radvlm_tpu_torch.models import radvlm as trad
        from radvlm_tpu_torch.training import checkpoint as ckpt
        families = {"moe": dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=40,
                                norm_topk_prob=True, attention_bias=False),
                    "mpt": dict(num_kv_heads=4, attention_bias=False, tie_word_embeddings=True,
                                hidden_act="gelu", pos_embedding="alibi", norm_kind="layernorm",
                                mlp_gated=False)}
        for fam, fields in families.items():
            fcfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, **fields))
            fmodel = init_params(fcfg, torch.Generator().manual_seed(8), device="cpu",
                                 dtype=torch.float32)
            fb = batch_to_device(multimodal.collate([multimodal.build_sample(
                Tok.encode("hi") + [-200], [img], fcfg)]), "cpu")
            logits, _ = trad.forward(fmodel, fcfg, fb)
            assert logits.shape[-1] == 300 and torch.isfinite(logits).all()
            if fam == "moe":
                hf_export.save_radvlm_hf(fmodel, fcfg, f"{data}/hf_moe")
                assert hf_import.config_from_hf_dir(f"{data}/hf_moe").text.num_experts == 4
            else:
                assert "transformer.blocks.0.attn.Wqkv.weight" in hf_export.export_mpt(fmodel.text)
        tiny = tiny_cfg()
        st, _, _ = ts.setup_training(tiny, tcfg, init_params(
            tiny, torch.Generator().manual_seed(9), device="cpu", dtype=torch.float32))
        assert ckpt.save_state(ckpt.CheckpointManager(f"{data}/ckpt"), 1, st, force=True)
        convert_cli.main(["--checkpoint-dir", f"{data}/ckpt", "--model-size", "tiny",
                          "--output", f"{data}/hf_tiny", "--verify", "--device", "cpu"])
        assert os.path.exists(f"{data}/hf_tiny/model.safetensors")
        # M10's towers and resamplers: every tower kind (CLIP with S2) and
        # every resampler in a tiny model's forward, the importers, the
        # tower dispatch and `with_tower`.
        from radvlm_tpu_torch.config import ResamplerConfig
        from radvlm_tpu_torch.models import clip, eva, imagebind, towers
        from radvlm_tpu_torch.models import resampler as tres
        tiny_vis = {
            "clip": clip.CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                                          num_heads=2, image_size=56, patch_size=14,
                                          s2_scales=(56, 112)),
            "eva": eva.EVAVisionConfig(hidden_size=32, head_dim=16, num_layers=2,
                                       intermediate_size=48, image_size=56, patch_size=14,
                                       rope_pt_seq_len=4),
            "imagebind": imagebind.ImageBindVisionConfig(hidden_size=32, intermediate_size=64,
                                                         num_layers=2, num_heads=2,
                                                         image_size=56, patch_size=14,
                                                         embed_dim=16),
        }
        rs = {"pad": [ResamplerConfig(kind="perceiver", depth=1, num_latents=4, num_heads=2,
                                      head_dim=8),
                      ResamplerConfig(kind="qformer", depth=2, num_latents=4, qformer_layers=2,
                                      qformer_hidden=32, qformer_heads=2,
                                      qformer_intermediate=64)],
              "anyres_max_9": [ResamplerConfig(kind="spatial_pool"),
                               ResamplerConfig(kind="masked_drop")]}
        combos = [(v, ResamplerConfig(), "pad" if k == "imagebind" else "anyres_max_9")
                  for k, v in tiny_vis.items()]
        combos += [(cfg.vision, r, a) for a, rr in rs.items() for r in rr]
        for vis, rcfg, aspect in combos:
            vcfg = dataclasses.replace(cfg, vision=vis, resampler=rcfg, image_aspect_ratio=aspect)
            vmodel = init_params(vcfg, torch.Generator().manual_seed(11), device="cpu",
                                 dtype=torch.float32)
            vb = batch_to_device(multimodal.collate([multimodal.build_sample(
                Tok.encode("hi") + [-200], [img], vcfg)]), "cpu")
            logits, _ = trad.forward(vmodel, vcfg, vb,
                                     resampler_generator=torch.Generator().manual_seed(0))
            assert torch.isfinite(logits).all(), (towers.kind(vis), rcfg.kind)
        assert towers.config_from_tower_name("EVA-CLIP-8B").head_dim == 128
        c7 = towers.with_tower(cfg, "imagebind_huge")
        assert c7.image_aspect_ratio == "pad" and c7.anyres.tile_size == 224
        # Each HF importer fills a module from its checkpoint layout, and
        # the module runs.
        from tower_layouts import (eva_state, hf_clip_state, imagebind_state, open_clip_state,
                                   qformer_state)
        g, rng = torch.Generator().manual_seed(12), np.random.default_rng(12)
        hf = hf_clip_state(tiny_vis["clip"], 2, g)
        eva_sd = {k: torch.from_numpy(v) for k, v in eva_state(tiny_vis["eva"], rng).items()}
        px = torch.randn(1, 56, 56, 3, generator=g)
        for name, importer, state in (
                ("clip", hf_import.import_clip, hf_import.normalize_keys(hf)),
                ("clip", hf_import.import_open_clip, open_clip_state(hf)),
                ("imagebind", hf_import.import_imagebind,
                 imagebind_state(hf, rng, tiny_vis["imagebind"])),
                ("eva", hf_import.import_eva, eva_sd)):
            vis = tiny_vis[name]
            tower = towers.build(vis, device="cpu", dtype=torch.float32)
            importer(state, tower)
            out = towers.forward(tower, vis, px)
            assert out.shape == (1, vis.tokens_per_tile, towers.feature_size(vis)), name
            assert torch.isfinite(out).all(), name
        qcfg = rs["pad"][1]
        qf = tres.build(qcfg, 24, device="cpu", dtype=torch.float32)
        hf_import.import_qformer({k: torch.from_numpy(v)
                                  for k, v in qformer_state(qcfg, 24, rng).items()}, qf)
        out = tres.forward(qf, qcfg, torch.randn(2, 16, 24, generator=g))
        assert out.shape == (2, 4, 32) and torch.isfinite(out).all()
        # M12's serving layouts: a TP engine on two spawned gloo ranks (the
        # spawn helper imports no jax), then in this process a world of one:
        # the mesh, ring attention through mha, SP generation, a fleet of two
        # engines behind FleetEngine, BatchWorker and run_task, and eval.cli
        # with --multihost and --fleet.
        import torch_dist
        from radvlm_tpu_torch.generation import engine as teng
        from radvlm_tpu_torch.models.convert import radvlm_to_tree
        from radvlm_tpu_torch.ops.attention import mha
        from radvlm_tpu_torch.parallel import mesh as pmesh, ring, tp
        from radvlm_tpu_torch.serve.batch_worker import BatchWorker
        from radvlm_tpu_torch.serve.fleet import FleetEngine
        tree = radvlm_to_tree(init_params(cfg, torch.Generator().manual_seed(13), device="cpu",
                                          dtype=torch.float32))
        tp_out = torch_dist.run(torch_dist.tp_engines, 2, dict(
            cfg=cfg, params=tree, lengths=(6, 9),
            runs={"bf16": ({}, dict(max_new_tokens=3))}), tempfile.mkdtemp())
        assert tp_out[0]["bf16"] == tp_out[1]["bf16"] and tp_out[0]["bf16_provenance"]["tp"] == 2
        # Pipeline parallelism (parallel.pp): the gradients of two stages on
        # two spawned gloo ranks, and the JAX layout's fold round trip.
        from radvlm_tpu_torch.parallel import pp
        pp_out = torch_dist.run(torch_dist.pp_cases, 2, dict(
            cfg=cfg, params=tree, batches=[multimodal.collate([train_sample, train_sample])],
            cases=[dict(kind="grads", shape={"stage": 2})]), tempfile.mkdtemp())
        assert pp_out[0][0][0] == pp_out[1][0][0] and np.isfinite(pp_out[0][0][0])
        folded = pp.fold_layers_interleaved(tree, 2, 1)
        assert pp.canonicalize_layer_stacks(folded, cfg.text.num_layers)["text"]["norm"] is \
            tree["text"]["norm"]
        assert pmesh.init_distributed() == (0, 1)
        world = pmesh.make_mesh({"seq": -1})
        assert pmesh.local_mesh_info(world) == (1, 1)
        ring.enable_ring_attention(world)
        qr = torch.randn(1, 16, 2, 8)
        assert torch.allclose(mha(qr, qr, qr, causal=True, impl="ring"),
                              mha(qr, qr, qr, causal=True, impl="xla"), atol=1e-5)
        ring.enable_ring_attention(None)
        sp_batch = batch_to_device(multimodal.collate(
            [multimodal.build_sample(Tok.encode("hi") + [-200], [img], cfg)], pad_len=128,
            left_pad=True), "cpu")
        sp = teng.make_sp_generate_fn(cfg, world, GenerationConfig(max_new_tokens=3),
                                      kv_quant=True)(model, sp_batch)
        assert sp["tokens"].shape == (1, 3)
        fl = FleetEngine(model, cfg, GenerationConfig(max_new_tokens=3), devices=["cpu"] * 2,
                         num_slots=2, max_len=256, prompt_buckets=(128,), pad_tiles=2).start()
        fr = [fl.submit(sample) for _ in range(3)]
        assert sorted(r.uid for r in fl.drain(idle_timeout=120)) == [r.uid for r in fr]
        fl.shutdown()
        fw = BatchWorker(VLMRunner(model=model, cfg=cfg, tokenizer=Tok(), max_new_tokens=2),
                         model_names=["t"], num_slots=2, max_len=256, prompt_bucket=128,
                         pad_tiles=2, fleet=2, fleet_devices=["cpu", "cpu"])
        assert fw.generate({"prompt": "hi", "max_new_tokens": 2})["error_code"] == 0
        fw.shutdown()
        fleet_runner = VLMRunner(model=model, cfg=cfg, tokenizer=Tok(), max_new_tokens=3,
                                 batch_size=2, fleet=2, fleet_devices=["cpu", "cpu"])
        results, _ = run_task(fleet_runner, build_task_dataset("abnormality_grounding", data),
                              "abnormality_grounding", with_clinical=False)
        assert len(results) == 2
        metrics = eval_cli.main(["--task", "abnormality_grounding", "--checkpoint", art,
                                 "--data-dir", data, "--output-dir", f"{data}/cli_fleet",
                                 "--max-new-tokens", "3", "--batch-size", "2", "--device",
                                 "cpu", "--multihost", "--fleet", "2", "--fleet-devices",
                                 "cpu,cpu"], tokenizer=Tok())
        assert "mAP_0.5" in metrics and tp.context() is None
        # A fleet of TP engines runs one process a rank: in this world of one
        # it raises naming torchrun (its lockstep runs in test_torch_fleet_tp).
        try:
            FleetEngine(model, cfg, GenerationConfig(max_new_tokens=3), fleet_size=2, tp_size=2)
            raise AssertionError("a fleet of TP engines in a world of one")
        except ValueError as e:
            assert "torchrun" in str(e)
        # Data preparation: the exporters, both builders' mains over the
        # VinDr split (their mixtures stubbed to it), synth_cli with the fake
        # client, the two preprocessors (a fake pydicom).
        import types
        from radvlm_tpu_torch.data import create_exports, create_llava_dataset, export
        from radvlm_tpu_torch.data import synth_cli
        from radvlm_tpu_torch.data.preprocess import dicom2jpg, normalize_mscxr
        vindr_split = build_task_dataset("abnormality_grounding", data)
        cells = export.export_dataset([export.MixtureEntry(vindr_split, "vindr", repeats=2)],
                                      export.grpo_rec_cell, data_root=data, num_workers=2)
        assert len(cells) == 4 and cells[2]["id"] == "vindr_0_rep1"
        export.write_jsonl(cells, f"{data}/exp/rec.jsonl")
        mixture = lambda d: [export.MixtureEntry(vindr_split, "vindr")]
        create_exports.grounding_mixture = create_llava_dataset.build_mixture = mixture
        create_exports.build_mixture = mixture
        create_exports.main(["--data-dir", data, "--format", "vlmr1", "--output",
                             f"{data}/exp/vlmr1.jsonl", "--num-workers", "1"])
        create_llava_dataset.main(["--data-dir", data, "--output", f"{data}/exp/all.json"])
        assert len(json.load(open(f"{data}/exp/all.json"))) == 2
        assert synth_cli.main(["filter-reports", "--data-dir", data, "--split", "test",
                               "--client", "fake", "--num-workers", "1", "--output-dir",
                               f"{data}/filtered"]) == 0
        assert os.listdir(f"{data}/filtered")
        write(f"{data}/ms.csv", [["dicom_id", "label_text", "x", "y", "w", "h", "image_width",
                                  "image_height"], ["d1", "heart", 10, 20, 30, 40, 100, 100]])
        assert normalize_mscxr.convert(f"{data}/ms.csv", f"{data}/ms") == 1
        sys.modules["pydicom"] = types.SimpleNamespace(dcmread=lambda path: types.SimpleNamespace(
            pixel_array=np.arange(600 * 512).reshape(600, 512) % 4096,
            PhotometricInterpretation="MONOCHROME1"))
        os.makedirs(f"{data}/dcm")
        open(f"{data}/dcm/x_0.dicom", "wb").close()
        assert dicom2jpg.convert_split(f"{data}/dcm", f"{data}/dcm_jpg", f"{data}/res.json",
                                       num_workers=1) == {"x_0": [512, 600]}
        # The C++ host prep: both libraries built into a fresh directory,
        # the tiler against PIL's tiles, the decoder against PIL, the routes.
        from radvlm_tpu_torch import kernels, native
        from radvlm_tpu_torch.config import AnyResConfig
        from radvlm_tpu_torch.data.loader import load_image
        from radvlm_tpu_torch.ops import image_ops
        kernels.BUILD_DIR = tempfile.mkdtemp()
        native.build()
        big = np.random.default_rng(2).integers(0, 255, (520, 460, 3), dtype=np.uint8)
        pil_tiles, _ = image_ops.preprocess_anyres_host(big, AnyResConfig())
        os.environ["RADVLM_NATIVE_ANYRES"] = os.environ["RADVLM_NATIVE_JPEG"] = "1"
        nat_tiles, _ = image_ops.preprocess_anyres_host(big, AnyResConfig())
        assert np.abs(nat_tiles.astype(int) - pil_tiles.astype(int)).max() <= 2
        jpath = f"{vindr}/test_jpg/a.jpg"
        assert np.array_equal(load_image(jpath), native.decode_jpeg(open(jpath, "rb").read()))
        del os.environ["RADVLM_NATIVE_ANYRES"], os.environ["RADVLM_NATIVE_JPEG"]
        assert np.array_equal(load_image(jpath), native.decode_jpeg(open(jpath, "rb").read()))
        # M12's training half in the world of one: a ZeRO-3 step through the
        # zigzag ring (its helpers on the host batch), qgZ's sum, the rules.
        from radvlm_tpu_torch.parallel import compression, sharding
        from radvlm_tpu_torch.training import loop as tloop
        host = multimodal.collate([multimodal.pack_samples([train_sample, train_sample])])
        assert ring.zigzag_indices(8, 2).tolist() == [0, 1, 6, 7, 2, 3, 4, 5]
        fmesh = pmesh.make_mesh({"fsdp": -1})
        ring.enable_ring_attention(fmesh, schedule="zigzag")
        sm_model = init_params(cfg, torch.Generator().manual_seed(2), device="cpu",
                               dtype=torch.float32)
        sst, sstep, _ = ts.setup_training(cfg, tcfg, sm_model, attn_impl="ring", mesh=fmesh)
        sst, smet = sstep(sst, batch_to_device(tloop.rank_batch(host, sst.mesh, "ring"), "cpu"))
        ring.enable_ring_attention(None)
        assert abs(float(smet["loss"]) - float(metrics_first)) < 1e-4
        assert sharding.sharded(sm_model).units and sharding.placement(
            "text.layers.0.q.weight").tensor_dim == 0
        assert torch.equal(compression.quantized_psum(torch.ones(5)), torch.ones(5))
        print(runner.generate_batch(["<image>\\nhi"], [[img]]))
        loaded = [k for k, v in sys.modules.items() if v is not None]
        for blocked in ("jax", "radvlm_tpu", "optax", "orbax", "flax", "pandas", "sklearn",
                        "requests", "rouge_score", "nltk"):
            assert not [k for k in loaded if k.split(".")[0] == blocked], blocked
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    toks = eval(out.stdout.strip().splitlines()[-1])[0]
    assert len(eval(toks)) > 0


PRESETS = ["tiny_test_config", "radvlm_0_5b", "radvlm_7b", "qwen2_0_5b", "qwen2_7b", "llama3_8b",
           "mistral_7b", "mixtral_8x7b", "gemma_2b", "mpt_7b"]
CONSTANTS = ["IGNORE_INDEX", "IMAGE_TOKEN_INDEX", "DEFAULT_IMAGE_TOKEN"]


# The tower configs' copies: each class's defaults, the open_clip table and
# every EVA name the dispatch knows.
TOWER_CONFIGS = ["CLIPVisionConfig", "EVAVisionConfig", "ImageBindVisionConfig",
                 "_OPEN_CLIP_MODELS", "EVA02-CLIP-L-14-336", "EVA02-CLIP-L-14", "EVA02-CLIP-B-16",
                 "EVA-CLIP-8B", "EVA-CLIP-8B-plus"]


def _tower_config(name: str):
    """(the port's, the JAX package's) object behind a TOWER_CONFIGS name."""
    from radvlm_tpu.models import clip as jclip
    from radvlm_tpu.models import eva as jeva
    from radvlm_tpu.models import imagebind as jib
    from radvlm_tpu.models import towers as jtowers
    from radvlm_tpu_torch.models import clip, eva, imagebind, towers

    if name == "_OPEN_CLIP_MODELS":
        return towers._OPEN_CLIP_MODELS, jtowers._OPEN_CLIP_MODELS
    mods = {"CLIPVisionConfig": (clip, jclip), "EVAVisionConfig": (eva, jeva),
            "ImageBindVisionConfig": (imagebind, jib)}
    if name in mods:
        mine, theirs = (getattr(m, name)() for m in mods[name])
    else:
        mine, theirs = towers._eva_config(name), jtowers._eva_config(name)
    assert type(mine).__module__.startswith("radvlm_tpu_torch.")
    for prop in ("kind", "tokens_per_tile", "feature_size", "patches_per_side", "head_dim",
                 "num_heads", "mean", "std"):
        assert getattr(mine, prop) == getattr(theirs, prop), prop
    return mine, theirs


@pytest.mark.parametrize("name", PRESETS + CONSTANTS + TOWER_CONFIGS)
def test_port_config_equals_jax_config(name):
    """The port keeps its own copy of the config module and of the tower
    configs: every preset it exports equals the JAX package's field by
    field, and so do the three constants, the three tower config classes,
    the open_clip table and every EVA config; a config object of either
    package drives the port."""
    import dataclasses

    from radvlm_tpu_torch import config as tcfg

    if name in CONSTANTS:
        assert getattr(tcfg, name) == getattr(cfglib, name)
        return
    if name in TOWER_CONFIGS:
        mine, theirs = _tower_config(name)
        if name == "_OPEN_CLIP_MODELS":
            assert mine == theirs
            return
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert ([f.name for f in dataclasses.fields(mine)]
                == [f.name for f in dataclasses.fields(theirs)])
        return
    mine, theirs = getattr(tcfg, name)(), getattr(cfglib, name)()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(theirs)]
    assert type(mine).__module__ == "radvlm_tpu_torch.config"
    if name.startswith(("radvlm", "tiny")):
        assert tcfg.tokens_per_tile(mine) == tcfg.tokens_per_tile(theirs) == theirs.tokens_per_tile
