"""The port's training data pipeline against the JAX package's: the same
cells, images and seed give the same epoch plan and, bit for bit, the same
batch arrays; `skip=` resumes mid-epoch; positional skipping draws the same
offsets (both draw them with numpy).
"""

import json
import os

import numpy as np
import pytest

from radvlm_tpu import config as cfglib
from radvlm_tpu.data import export as jexport
from radvlm_tpu.data import loader as jloader
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu_torch.config import tiny_test_config
from radvlm_tpu_torch.data import export as texport
from radvlm_tpu_torch.data import loader as tloader
from radvlm_tpu_torch.data.chat import llava_turns, tokenize_chat_supervised
from radvlm_tpu_torch.models import multimodal as tmm


def _tok(text):
    return [2 + b for b in text.encode()]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("llava")
    rng = np.random.default_rng(3)
    cells = []
    for i in range(14):
        cell = {"id": str(i), "conversations": [
            {"from": "human", "value": ("<image>\n" if i % 5 else "") + "Question " * (1 + i % 4)},
            {"from": "gpt", "value": "Answer " * (1 + (3 * i) % 7)}]}
        if i % 5:
            name = f"img{i}.png"
            Image.fromarray(rng.integers(0, 255, (50 + 7 * i, 70 + 3 * i, 3), dtype=np.uint8)).save(
                os.path.join(root, name))
            cell["image"] = name
        if i % 4 == 0:
            cell["conversations"] += [{"from": "human", "value": "And the heart?"},
                                      {"from": "gpt", "value": "Normal."}]
        cells.append(cell)
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(cells, f)
    return str(root), path, cells


BUCKETS = ((1536, 12), (4096, 24))


def _loaders(data, **kw):
    root, _, cells = data
    out = []
    for mod, cfg in ((jloader, cfglib.tiny_test_config()), (tloader, tiny_test_config())):
        ds = mod.LlavaJsonDataset(cells=cells, image_root=root, cfg=cfg, tokenize_fn=_tok,
                                  max_len=4096)
        out.append(mod.PrefetchLoader(
            ds, buckets=tuple(mod.Bucket(*b) for b in BUCKETS), num_workers=2, **kw))
    return out


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    return a


def test_supervised_tokenization_matches_jax(data):
    from radvlm_tpu.data import chat as jchat

    for cell in data[2]:
        turns = llava_turns(cell["conversations"])
        assert turns == jchat.llava_turns(cell["conversations"])
        assert tokenize_chat_supervised(_tok, turns) == jchat.tokenize_chat_supervised(_tok, turns)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("batch_size,pack", [(2, 1), (1, 3), (2, 2)])
def test_epoch_plan_and_batches_match_jax(data, batch_size, pack, seed):
    jl, tl = _loaders(data, batch_size=batch_size, seed=seed, pack_factor=pack)
    assert jl._lengths == tl._lengths
    for epoch in (0, 1):
        assert jl.epoch_plan(epoch) == tl.epoch_plan(epoch)
    batches = _same_batches(jl.epoch(0), tl.epoch(0))
    if pack > 1:  # some row really holds several segments
        assert max(int(b["segment_ids"].max()) for b in batches) > 1


def test_skip_resumes_mid_epoch(data):
    jl, tl = _loaders(data, batch_size=2, seed=1)
    whole = list(tl.epoch(1))
    rest = _same_batches(jl.epoch(1, skip=2), tl.epoch(1, skip=2))
    assert len(rest) == len(whole) - 2
    for x, y in zip(whole[2:], rest):
        for k in x:
            assert np.array_equal(x[k], y[k]), k


def test_pos_skipping_draws_the_same_offsets(data):
    jl, tl = _loaders(data, batch_size=2, seed=2, pos_skip_range=4096)
    batches = _same_batches(jl.epoch(0), tl.epoch(0))
    assert max(int(b["positions"].max()) for b in batches) > 512  # offsets were added
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    plain = list(_loaders(data, batch_size=2, seed=2)[1].epoch(0))[0]
    a = jloader.apply_pos_skipping(plain, rng_a, 100)
    b = tloader.apply_pos_skipping(plain, rng_b, 100)
    assert np.array_equal(a["positions"], b["positions"])
    assert np.all(b["positions"][plain["segment_ids"] == 0] == 0)


def test_buckets_and_plans_match_jax():
    lengths = [10, 1024, 1025, 5000, 9000, 300, 2048, 4097, 77, 6144]
    assert tloader.DEFAULT_BUCKETS == tuple(
        tloader.Bucket(b.max_len, b.max_tiles) for b in jloader.DEFAULT_BUCKETS)
    assert tloader.assign_buckets(lengths, tloader.DEFAULT_BUCKETS) == jloader.assign_buckets(
        lengths, jloader.DEFAULT_BUCKETS)
    for kw in (dict(seed=3), dict(seed=4, process_index=1, process_count=3),
               dict(seed=0, drop_remainder=False)):
        assert tloader.bucketed_batches(lengths * 3, 2, **kw) == jloader.bucketed_batches(
            lengths * 3, 2, **kw)


def test_pack_samples_and_collate_match_jax(data):
    root, _, cells = data
    samples = []
    for mod, cfg in ((jloader, cfglib.tiny_test_config()), (tloader, tiny_test_config())):
        ds = mod.LlavaJsonDataset(cells=cells, image_root=root, cfg=cfg, tokenize_fn=_tok)
        samples.append([ds[i] for i in (1, 5, 2, 0)])
    for rows in ([[0, 1, 2], [3]], [[0], [1, 2, 3]], [[0, 1, 2, 3]]):
        jb = jmm.collate([jmm.pack_samples([samples[0][i] for i in r]) for r in rows],
                         pad_len=384, pad_tiles=9)
        tb = tmm.collate([tmm.pack_samples([samples[1][i] for i in r]) for r in rows],
                         pad_len=384, pad_tiles=9)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k


def test_load_mixture_matches_jax(data, tmp_path):
    root, path, cells = data
    assert texport.load_mixture(path) == jexport.load_mixture(path) == cells
    other = os.path.join(tmp_path, "b.json")
    with open(other, "w") as f:
        json.dump(cells[:3], f)
    os.replace(other, os.path.join(root, "b.json"))
    glob = os.path.join(root, "{train,b}.json")
    assert texport.load_mixture(glob) == jexport.load_mixture(glob)
    recipe = os.path.join(tmp_path, "mix.yaml")
    with open(recipe, "w") as f:
        f.write("datasets:\n"
                f"  - json_path: {path}\n    sampling_strategy: \"random:50%\"\n"
                f"  - json_path: {path}\n    sampling_strategy: \"end:2\"\n"
                f"  - json_path: {os.path.join(root, 'b.json')}\n    sampling_strategy: first:1\n"
                f"  - json_path: {path}\n")
    got = texport.load_mixture(recipe)
    assert got == jexport.load_mixture(recipe) and len(got) == 7 + 2 + 1 + 14
    with pytest.raises(ValueError):
        texport.apply_sampling_strategy(cells, "middle:3")


_SPECIALS = {"<|im_start|>": 1, "<|im_end|>": 2, "<image>": 3}


def _chatml_tok(split_newline):
    """ChatML-style tokenizer: the specials are single ids, other text is
    bytes; with `split_newline` "\\n" encodes as two tokens."""

    def tok(s):
        out, i = [], 0
        while i < len(s):
            for sp, tid in _SPECIALS.items():
                if s.startswith(sp, i):
                    out.append(tid)
                    i += len(sp)
                    break
            else:
                out.extend([256 + 10, 300] if (split_newline and s[i] == "\n") else [256 + ord(s[i])])
                i += 1
        return out

    return tok


def _preprocess_qwen_oracle(tok, source, system_message="You are a helpful assistant."):
    """The reference's `preprocess_qwen` (train.py:560-633) in semantics:
    per-turn renders, system and user turns masked, assistant turns fully
    supervised (role prefix included), the single-token ids of "\\n",
    <|im_start|> and <|im_end|> unmasked everywhere, <image> replaced by the
    sentinel with its label untouched."""
    from radvlm_tpu_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX

    unmask = [enc[0] for enc in map(tok, ("\n", "<|im_start|>", "<|im_end|>")) if len(enc) == 1]
    render = lambda role, content: tok(f"<|im_start|>{role}\n{content}<|im_end|>\n")
    input_id, target = [], []
    enc = render("system", system_message)
    input_id += enc
    target += [IGNORE_INDEX] * len(enc)
    for role, content in source:
        enc = render(role, content)
        input_id += enc
        target += [IGNORE_INDEX] * len(enc) if role in ("user", "system") else enc
    for idx, t in enumerate(input_id):
        if t in unmask:
            target[idx] = t
        if t == _SPECIALS["<image>"]:
            input_id[idx] = IMAGE_TOKEN_INDEX
    return input_id, target


@pytest.mark.parametrize("ref_masking,split_newline", [(False, False), (True, False), (True, True)],
                         ids=["default", "ref_masking", "two_token_newline"])
def test_ref_masking_matches_jax_and_preprocess_qwen(ref_masking, split_newline):
    from radvlm_tpu.data import chat as jchat
    from radvlm_tpu_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX

    tok = _chatml_tok(split_newline)
    turns = [
        ("user", "<image>\nWhat do you see?"),
        ("assistant", "Cardiomegaly.\nNo effusion."),
        ("user", "Where?"),
        ("assistant", "At [0.30, 0.40, 0.70, 0.80]."),
    ]
    ids, labels = tokenize_chat_supervised(tok, turns, ref_masking=ref_masking)
    assert (ids, labels) == jchat.tokenize_chat_supervised(tok, turns, ref_masking=ref_masking)
    supervised = [t for t, l in zip(ids, labels) if l != IGNORE_INDEX]
    assert labels[ids.index(IMAGE_TOKEN_INDEX)] == IGNORE_INDEX
    if not ref_masking:
        # The role prefix is prompt: <|im_start|> is never supervised.
        assert _SPECIALS["<|im_start|>"] not in supervised
        assert (ids, labels) == tokenize_chat_supervised(tok, turns)
        return
    assert (ids, labels) == _preprocess_qwen_oracle(tok, turns)
    assert _SPECIALS["<|im_start|>"] in supervised
    user_end = ids.index(_SPECIALS["<|im_end|>"], ids.index(IMAGE_TOKEN_INDEX))
    user_newlines = [i for i in range(user_end) if ids[i] == 256 + 10]
    assert user_newlines
    for i in user_newlines:  # a "\n" of a user turn: unmasked only as one token
        assert (labels[i] == IGNORE_INDEX) == split_newline
