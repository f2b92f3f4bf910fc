"""The port's text-only LM engine (`generation/text_lm.py`) and the GREEN
CLI on it, against the JAX package's and against transformers.

A 2-layer Llama of width 48 (4 heads of dim 12, MHA like Llama-2) from
`transformers.LlamaForCausalLM` with random weights, saved with a
byte-level BPE tokenizer from `tokenizers` (no merges: one token a byte).

- f32: the port's `TextLMEngine` greedy text equals the JAX engine's and
  HF `generate`'s exactly (greedy argmax over logits that agree to ~1e-6).
- int8 (`quantize_model` / the JAX `quantize_params` at load), with
  RADVLM_W8A8=0 (W8A8 turns f32-level differences into int8 flips): the
  greedy text equals the JAX int8 engine's exactly; with W8A8 on, the
  prefill logits agree to 2e-2 of their largest magnitude.
- The tiny vision tower rides along but is never spliced: the tokens are
  the same after the tower, projector and image_newline are re-drawn from
  another seed.
- `green_cli.main --judge torch --device cpu` end to end.
- RADVLM_KV_INT8: `ContinuousBatcher(kv_quant=None)` and the port's
  `BatchWorker` read it as the JAX package's batcher does.

Each JAX engine is built once, in a module-scoped fixture (its first fill
and decode compile).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as jcfg
from radvlm_tpu.generation.continuous import ContinuousBatcher as JBatcher
from radvlm_tpu.generation.engine import GenerationConfig as JGen
from radvlm_tpu.generation.text_lm import TextLMEngine as JEngine
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu_torch import config as tcfg
from radvlm_tpu_torch.eval import green_cli
from radvlm_tpu_torch.eval.harness import VLMRunner
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher as TBatcher
from radvlm_tpu_torch.generation.engine import GenerationConfig as TGen
from radvlm_tpu_torch.generation.text_lm import TextLMEngine
from radvlm_tpu_torch.models import convert
from radvlm_tpu_torch.serve.batch_worker import BatchWorker

NEW = 8
PROMPTS = ["Reference report: clear lungs.", "Candidate: effusion seen.",
           "Findings: mild cardiomegaly, no pneumothorax. Impression: stable."]


def byte_tokenizer():
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    alphabet = pre_tokenizers.ByteLevel.alphabet()
    vocab = {ch: i for i, ch in enumerate(sorted(alphabet))}
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    return PreTrainedTokenizerFast(
        tokenizer_object=tok, eos_token="<|eos|>", pad_token="<|pad|>",
        model_input_names=["input_ids", "attention_mask"],
    )


def write_llama(path):
    """A tiny Llama checkpoint + its tokenizer under `path`; returns the
    HF model and the tokenizer."""
    from transformers import LlamaConfig, LlamaForCausalLM

    tok = byte_tokenizer()
    tok.save_pretrained(path)
    torch.manual_seed(0)
    cfg = LlamaConfig(
        vocab_size=len(tok), hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=4096, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False, eos_token_id=tok.eos_token_id,
    )
    model = LlamaForCausalLM(cfg)
    model.eval()
    model.save_pretrained(path, safe_serialization=True)
    return model, tok


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    path = tmp_path_factory.mktemp("llama_judge")
    model, tok = write_llama(path)
    return str(path), model, tok


@pytest.fixture(scope="module")
def jax_f32_texts(llama):
    path = llama[0]
    eng = JEngine(path, max_new_tokens=NEW, num_slots=2, dtype=jnp.float32)
    try:
        return eng.generate_batch(PROMPTS)
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def jax_int8(llama):
    """The JAX int8 engine's greedy texts (RADVLM_W8A8=0) and its engine."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RADVLM_W8A8", "0")
        eng = JEngine(llama[0], max_new_tokens=NEW, num_slots=2, int8=True, dtype=jnp.float32)
        try:
            return eng.generate_batch(PROMPTS), eng
        finally:
            eng.shutdown()


def _port(path, **kw):
    return TextLMEngine(path, max_new_tokens=NEW, num_slots=2, dtype=torch.float32,
                        device="cpu", **kw)


def test_f32_engine_equals_jax_and_hf_generate(llama, jax_f32_texts):
    path, model, tok = llama
    eng = _port(path)
    try:
        got = eng.generate_batch(PROMPTS)
        assert eng.generate(PROMPTS[1]) == got[1]  # alone, in either slot
    finally:
        eng.shutdown()
    assert got == jax_f32_texts
    for p, text in zip(PROMPTS, got):
        ids = tok(p, add_special_tokens=True).input_ids
        with torch.no_grad():
            out = model.generate(torch.tensor([ids]), max_new_tokens=NEW, do_sample=False,
                                 pad_token_id=tok.pad_token_id)
        assert text == tok.decode(out[0][len(ids):], skip_special_tokens=True)
    assert any(got)
    assert eng.batcher.kv_quant is False and eng.batcher.pad_tiles == 1
    assert eng.cfg.text.num_kv_heads == eng.cfg.text.num_heads == 4
    assert eng.cfg.text.attention_bias is False and eng.cfg.text.rms_norm_eps == 1e-5


def test_int8_engine_equals_jax_int8(llama, jax_int8, monkeypatch):
    monkeypatch.setenv("RADVLM_W8A8", "0")
    eng = _port(llama[0], int8=True)
    try:
        got = eng.generate_batch(PROMPTS)
    finally:
        eng.shutdown()
    assert got == jax_int8[0]
    assert any(got)
    prov = eng.batcher.kernel_provenance()
    assert prov["decode_matmul"] == "int8" and prov["decode_lm_head"] == "int8"


W8A8_TOL = 2e-2  # max |port - jax| over max |jax| of the prefill logits


def test_int8_w8a8_prefill_logits_near_jax(llama, jax_int8):
    """With W8A8 on (the default), an f32-level difference can flip an
    activation's int8 rounding, so the int8 judges are held by their
    prefill logits, not tokens: max |port - jax| <= 2e-2 max |jax| on each
    prompt, and the same argmax."""
    from radvlm_tpu.generation import engine as jeng
    from radvlm_tpu.models import multimodal as jmm
    from radvlm_tpu_torch.generation import engine as teng
    from radvlm_tpu_torch.models import multimodal as tmm

    jengine = jax_int8[1]
    eng = _port(llama[0], int8=True)
    tok = eng.tokenizer
    for p in PROMPTS:
        ids = tok(p).input_ids
        kw = dict(pad_tiles=1, pad_to_multiple=128, left_pad=True)
        jb = jmm.collate([jmm.build_sample(ids, [], jengine.cfg)], **kw)
        tb = tmm.collate([tmm.build_sample(ids, [], eng.cfg)], **kw)
        _, _, want = jeng.prefill(jengine.batcher.params, jengine.cfg,
                                  {k: jnp.asarray(v) for k, v in jb.items()}, 256,
                                  attn_impl="xla")
        _, _, got = teng.prefill(eng.model, eng.cfg, {k: torch.from_numpy(v) for k, v in
                                                      tb.items()}, 256)
        want, got = np.asarray(want, np.float32)[0], got.float().numpy()[0]
        assert np.abs(got - want).max() <= W8A8_TOL * np.abs(want).max()
        assert got.argmax() == want.argmax()


def test_tokens_do_not_depend_on_the_tower(llama):
    eng = _port(llama[0])
    try:
        first = eng.generate_batch(PROMPTS)
        gen = torch.Generator().manual_seed(1)
        m = eng.model
        before = m.vision_tower.patch_embed.weight.clone()
        with torch.no_grad():
            for p in [*m.vision_tower.parameters(), *m.projector.parameters(),
                      m.image_newline]:
                p.normal_(0.0, 0.5, generator=gen)
        assert not torch.equal(before, m.vision_tower.patch_embed.weight)
        assert eng.generate_batch(PROMPTS) == first
    finally:
        eng.shutdown()


def test_engine_error_fails_the_batch(llama, monkeypatch):
    eng = _port(llama[0])

    def boom(*a, **kw):
        raise RuntimeError("injected engine fault")

    monkeypatch.setattr(eng.batcher, "_dispatch_chunk", boom)
    try:
        with pytest.raises(RuntimeError, match="text-lm engine failed: engine error: injected"):
            eng.generate_batch(PROMPTS[:2])
        monkeypatch.undo()  # the loop carries on: the next batch is served
        assert len(eng.generate_batch(PROMPTS[:1])) == 1
    finally:
        eng.shutdown()
    assert not eng._thread.is_alive()


def test_green_cli_torch_judge_end_to_end(llama, tmp_path, capsys):
    path = llama[0]
    outputs = [{"txt": "No acute findings.", "output": "Normal chest."},
               {"txt": "Cardiomegaly.", "output": "Enlarged heart."},
               {"txt": "Small effusion.", "output": "Left effusion."}]
    outs = tmp_path / "outputs.json"
    outs.write_text(json.dumps(outputs))
    save = tmp_path / "green.json"
    mean, scores = green_cli.main(["--outputs", str(outs), "--judge", "torch", "--judge-model",
                                   path, "--judge-slots", "2", "--max-samples", "2", "--save",
                                   str(save), "--device", "cpu"])
    assert "GREEN mean:" in capsys.readouterr().out
    assert json.loads(save.read_text()) == {"green_mean": mean, "scores": scores}
    assert len(scores) == 2
    with pytest.raises(RuntimeError, match="CUDA card"):  # no --device: the card
        green_cli.main(["--outputs", str(outs), "--judge-model", path])


@pytest.mark.parametrize("env", [None, "1", "0"])
def test_kv_quant_none_reads_radvlm_kv_int8(env, monkeypatch):
    """`kv_quant=None` follows RADVLM_KV_INT8 in both packages' batchers and
    in the port's BatchWorker; an explicit value wins."""
    if env is None:
        monkeypatch.delenv("RADVLM_KV_INT8", raising=False)
    else:
        monkeypatch.setenv("RADVLM_KV_INT8", env)
    want = env == "1"
    cfg = tcfg.tiny_test_config()
    params = jax.tree.map(np.asarray, jrad.init_params(jcfg.tiny_test_config(),
                                                      jax.random.key(0)))
    model = convert.radvlm_from_jax(params, cfg, device="cpu")
    kw = dict(num_slots=2, max_len=256, prompt_buckets=(128,))
    jb = JBatcher(params, jcfg.tiny_test_config(), JGen(max_new_tokens=2), **kw)
    tb = TBatcher(model, cfg, TGen(max_new_tokens=2), **kw)
    assert jb.kv_quant is tb.kv_quant is want
    assert tb.cache[0].dtype == (torch.int8 if want else torch.bfloat16)
    assert str(jb.cache[0].dtype) == ("int8" if want else "bfloat16")
    assert TBatcher(model, cfg, TGen(), kv_quant=not want, **kw).kv_quant is (not want)

    class Tok:
        eos_token_ids, pad_token_id = (1,), 0

    runner = VLMRunner(model=model, cfg=cfg, tokenizer=Tok(), max_new_tokens=2, fuse=False)
    worker = BatchWorker(runner, model_names=["tiny"], num_slots=2, max_len=256,
                         prompt_bucket=128, pad_tiles=1)
    try:
        assert worker.batcher.kv_quant is want
    finally:
        worker.shutdown()
