"""HF import and export of the port against the JAX package, for the dense
Qwen2 RadVLM (SigLIP tower, mlp2x_gelu projector), Qwen2-MoE, Mixtral and
MPT at tiny sizes. Weights are the JAX package's init (noisy norms and
biases), moved across by `models/convert.py`. Everything is compared bit
for bit, except where a forward runs: logits of identical weights must be
identical too.

- `hf_export`: the port's export dict equals the JAX one key for key;
- port export -> the JAX `load_radvlm_checkpoint` gives the original tree;
  the JAX `save_radvlm_hf` -> the port's `load_radvlm_checkpoint` gives
  the same parameters and logits as the bridged tree;
- `config_from_hf_dir` on qwen2_moe, mixtral (with a sliding window) and
  mpt config.json files equals the JAX result field by field;
- `save_radvlm_hf(resize_vocab=True)`: the grown rows, every tensor of the
  file and config.json equal the JAX package's;
- `convert_cli` end to end with `--verify` on a checkpoint that
  `training/checkpoint.py` saved, and the JAX package reads its output;
- `worker_cli --checkpoint <tiny Mixtral HF dir> --device cpu` answers.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.config import Qwen2Config
from radvlm_tpu.models import hf_export as jhx
from radvlm_tpu.models import hf_import as jhf
from radvlm_tpu.models import qwen2 as jq
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu_torch.eval.harness import batch_to_device
from radvlm_tpu_torch.models import convert, convert_cli, hf_export, hf_import, qwen2, radvlm
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.models import safetensors_io
from radvlm_tpu_torch.serve import worker_cli
from radvlm_tpu_torch.training import checkpoint as ckpt
from radvlm_tpu_torch.training import optimizer as topt
from radvlm_tpu_torch.training import train_step as tts

MOE = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=40,
           shared_expert_intermediate_size=56, norm_topk_prob=True)
TEXT = {
    "dense": {},
    "qwen2_moe": MOE,
    "mixtral": dict(MOE, shared_expert_intermediate_size=0, attention_bias=False,
                    sliding_window=16),
}
MPT_TINY = Qwen2Config(
    vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
    num_kv_heads=4, head_dim=8, rms_norm_eps=1e-5, attention_bias=False,
    tie_word_embeddings=True, hidden_act="gelu", pos_embedding="alibi", norm_kind="layernorm",
    mlp_gated=False, max_position_embeddings=512,
)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _noisy(params):
    noise = np.random.default_rng(1)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("bias", "ln1", "ln2", "norm", "scale") for k in p)
        else x,
        params,
    )


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _cfg(name, vocab=300):
    base = cfglib.tiny_test_config(vocab_size=vocab)
    return dataclasses.replace(base, text=dataclasses.replace(base.text, **TEXT[name]))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the tiny models' small ops: several test
    workers share the cores, and PyTorch's thread pools contend there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(TEXT))
def family(request):
    cfg = _cfg(request.param)
    params = _noisy(_np_tree(jrad.init_params(cfg, jax.random.key(0))))
    model = convert.radvlm_from_jax(params, cfg, device="cpu", dtype=torch.float32)
    return request.param, cfg, params, model


def _same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a = got[k].float().numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(a, np.asarray(want[k], np.float32), err_msg=k)


def test_export_dict_equals_jax(family):
    name, cfg, params, model = family
    state = hf_export.export_radvlm(model, cfg)
    _same_state(state, jhx.export_radvlm(params, cfg))
    router = "block_sparse_moe.gate.weight" if name == "mixtral" else "mlp.gate.weight"
    assert (f"language_model.model.layers.0.{router}" in state) == (name != "dense")


def test_mpt_export_equals_jax_and_round_trips():
    params = _noisy(_np_tree(jq.init_params(MPT_TINY, jax.random.key(1))))
    model = qwen2.Qwen2Decoder(MPT_TINY)
    convert.load_qwen2(model, params)
    state = hf_export.export_mpt(model)
    _same_state(state, jhx.export_mpt(params))
    back = qwen2.Qwen2Decoder(MPT_TINY)
    hf_import.import_qwen2(hf_import.normalize_keys(state), back)
    for (n, a), (_, b) in zip(model.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), n
    jback = jhf.import_qwen2(jhf.normalize_keys({k: v.numpy() for k, v in state.items()}),
                             MPT_TINY, dtype=jnp.float32)
    _same_state(_leaves(jback), _leaves(params))
    with pytest.raises(ValueError, match="export_mpt"):
        hf_export.export_qwen2(model)


def _batch(cfg):
    r = np.random.default_rng(5)
    img = r.integers(0, 255, (70, 90, 3), dtype=np.uint8)
    ids = [int(t) for t in r.integers(2, cfg.text.vocab_size, 5)] + [-200] + [7, 8, 9]
    return batch_to_device(tmm.collate([tmm.build_sample(ids, [img], cfg)],
                                       pad_to_multiple=128), "cpu")


def test_port_export_loads_in_jax_and_jax_export_in_the_port(family, tmp_path):
    name, cfg, params, model = family
    hf_export.save_radvlm_hf(model, cfg, str(tmp_path / "port"))
    back = jhf.load_radvlm_checkpoint(str(tmp_path / "port"), cfg, dtype=jnp.float32)
    _same_state(_leaves(back), _leaves(params))

    jhx.save_radvlm_hf(params, cfg, str(tmp_path / "jax"))
    loaded = hf_import.load_radvlm_checkpoint(str(tmp_path / "jax"), cfg, device="cpu",
                                              dtype=torch.float32)
    mine = dict(loaded.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p, mine[n]), n
    batch = _batch(cfg)
    with torch.no_grad():
        a, _ = radvlm.forward(model, cfg, batch)
        b, _ = radvlm.forward(loaded, cfg, batch)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    # The config.json of either writer builds the same config in either package.
    for d in ("port", "jax"):
        assert (dataclasses.asdict(hf_import.config_from_hf_dir(str(tmp_path / d)))
                == dataclasses.asdict(jhf.config_from_hf_dir(str(tmp_path / d))))


HF_CONFIGS = {
    "qwen2_moe": dict(model_type="qwen2_moe", vocab_size=300, hidden_size=48,
                      intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, num_experts=4, num_experts_per_tok=2,
                      moe_intermediate_size=40, shared_expert_intermediate_size=56,
                      norm_topk_prob=False, rope_theta=1e6),
    "mixtral": {"text_config": dict(model_type="mixtral", vocab_size=32000, hidden_size=4096,
                                    intermediate_size=14336, num_hidden_layers=32,
                                    num_attention_heads=32, num_key_value_heads=8,
                                    num_local_experts=8, num_experts_per_tok=2,
                                    sliding_window=4096, rope_theta=1e6, rms_norm_eps=1e-5),
                "vision_config": dict(hidden_size=1152, image_size=384, patch_size=14),
                "image_grid_pinpoints": [[384, 768], [768, 384]],
                "vision_aspect_ratio": "anyres_max_4"},
    "mpt": dict(model_type="mpt", d_model=4096, n_heads=32, n_layers=32, expansion_ratio=4,
                max_seq_len=2048, vocab_size=50432, layer_norm_epsilon=1e-5,
                attn_config={"alibi": True, "alibi_bias_max": 8}),
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_config_from_hf_dir_equals_jax(tmp_path, name):
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS[name]))
    mine = hf_import.config_from_hf_dir(str(tmp_path))
    theirs = jhf.config_from_hf_dir(str(tmp_path))
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert type(mine.text).__module__ == "radvlm_tpu_torch.config"
    if name == "mixtral":
        assert mine.text.sliding_window == 4096 and mine.text.num_experts == 8
        assert (dataclasses.asdict(mine.text)
                == dataclasses.asdict(dataclasses.replace(cfglib.mixtral_8x7b(),
                                                          sliding_window=4096)))
    if name == "mpt":
        assert dataclasses.asdict(mine.text) == dataclasses.asdict(cfglib.mpt_7b())


def test_resized_vocab_and_config_json_equal_jax(tmp_path):
    """bf16 weights: the grown rows are rounded to bf16, and the file holds
    every bf16 tensor as f32, as the JAX writer stores them."""
    cfg = _cfg("dense", vocab=250)
    params = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                          _noisy(_np_tree(jrad.init_params(cfg, jax.random.key(2)))))
    model = convert.radvlm_from_jax(params, cfg, device="cpu", dtype=torch.bfloat16)
    state = hf_export.export_radvlm(model, cfg)
    jstate = jhx.export_radvlm(params, cfg)
    assert hf_export.resize_vocab_for_hf(state) == jhx.resize_vocab_for_hf(jstate) == 256
    assert state["language_model.model.embed_tokens.weight"].dtype == torch.bfloat16
    _same_state(state, jstate)
    hf_export.save_radvlm_hf(model, cfg, str(tmp_path / "port"), resize_vocab=True)
    jhx.save_radvlm_hf(params, cfg, str(tmp_path / "jax"), resize_vocab=True)
    files = [safetensors_io.read_file(str(tmp_path / d / "model.safetensors"))
             for d in ("port", "jax")]
    assert files[0].keys() == files[1].keys()
    for k in files[1]:
        assert files[0][k].dtype == files[1][k].dtype == torch.float32, k
        assert torch.equal(files[0][k], files[1][k]), k
    configs = [json.loads((tmp_path / d / "config.json").read_text()) for d in ("port", "jax")]
    assert configs[0] == configs[1] and configs[0]["image_token_index"] == 250


def test_convert_cli_verifies_a_training_checkpoint(tmp_path):
    """A checkpoint saved by `training/checkpoint.py` (the tiny model after
    one optimizer step) -> `convert_cli --verify` -> an HF directory the JAX
    package loads into the checkpoint's tree."""
    cfg = cfglib.tiny_test_config()
    model = convert.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                dtype=torch.float32)
    state, _, _ = tts.setup_training(cfg, topt.TrainConfig(), model)
    manager = ckpt.CheckpointManager(str(tmp_path / "run"))
    assert ckpt.save_state(manager, 3, state, force=True)
    out = tmp_path / "hf"
    converted = convert_cli.main(["--checkpoint-dir", str(tmp_path / "run"), "--model-size",
                                  "tiny", "--output", str(out), "--verify", "--device", "cpu"])
    for (n, a), (_, b) in zip(model.named_parameters(), converted.named_parameters()):
        assert torch.equal(a, b), n
    back = jhf.load_radvlm_checkpoint(str(out), cfg, dtype=jnp.float32)
    _same_state(_leaves(back), _leaves(jax.tree.map(np.asarray, convert.radvlm_to_tree(model))))
    with pytest.raises(SystemExit, match="no checkpoints"):
        convert_cli.main(["--checkpoint-dir", str(tmp_path / "empty"), "--model-size", "tiny",
                          "--output", str(tmp_path / "x"), "--device", "cpu"])


class ByteTokenizer:
    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [2 + b for b in text.encode()]

    def decode(self, ids):
        return bytes(min(255, i - 2) for i in ids if i >= 2).decode(errors="ignore")


def test_worker_cli_serves_a_mixtral_hf_dir(tmp_path):
    """A tiny LLaVA-Mixtral written in the HF layout with Mixtral's own
    config.json vocabulary (model_type mixtral, num_local_experts) loads
    through `config_from_hf_dir` into `worker_cli`'s continuous worker,
    which answers over HTTP."""
    cfg = _cfg("mixtral", vocab=512)
    model = convert.init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                                dtype=torch.float32)
    hf_export.save_radvlm_hf(model, cfg, str(tmp_path))
    data = json.loads((tmp_path / "config.json").read_text())
    text = data["text_config"]
    for k in ("num_experts", "moe_intermediate_size", "shared_expert_intermediate_size",
              "norm_topk_prob", "decoder_sparse_step", "mlp_only_layers"):
        text.pop(k)
    text.update(model_type="mixtral", num_local_experts=4,
                intermediate_size=cfg.text.moe_intermediate_size, sliding_window=16)
    (tmp_path / "config.json").write_text(json.dumps(data))
    loaded_cfg = hf_import.config_from_hf_dir(str(tmp_path))
    assert loaded_cfg.text.num_experts == 4 and loaded_cfg.text.sliding_window == 16
    args = worker_cli.parse_args(["--checkpoint", str(tmp_path), "--device", "cpu",
                                  "--num-slots", "2", "--max-len", "256", "--prompt-bucket",
                                  "128", "--max-new-tokens", "4", "--model-names", "mixtral"])
    worker = worker_cli.build_worker(args, tokenizer=ByteTokenizer(), kv_quant=True, pad_tiles=2,
                                     steps_per_sync=4)
    assert hasattr(worker.runner.model.text.layers[0], "moe")
    import base64
    import io

    from PIL import Image

    img = np.random.default_rng(3).integers(0, 255, (90, 70, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    body = {"prompt": "<|im_start|>user\n<image>\nDescribe.<|im_end|>\n<|im_start|>assistant\n",
            "images": [base64.b64encode(buf.getvalue()).decode()], "max_new_tokens": 4}
    port = worker.serve_forever(host="127.0.0.1", port=0, background=True)
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/worker_generate",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
    finally:
        worker.shutdown()
    assert out["error_code"] == 0 and isinstance(out["text"], str)
