"""Entity-overlap report metrics: RadEntityMatchExact, RadEntityNLI, and the
Stanford CT-abdomen substring accuracy (the port's own copy of
`radvlm_tpu/eval/metrics/radentity.py`).

Rebuilds of the vendored vilmedic scorers the reference's `compute_scores`
registry can dispatch (`radvlm/evaluation/vilmedic/scores.py:113-128`,
`RadEntityMatchExact/RadEntityMatchExact.py`, `RadEntityNLI/RadEntityNLI.py`,
`StanfordCTAbdAcc/StanfordCTAbdAcc.py`). The scoring ALGORITHMS are pure
Python here; the external models they consume (stanza's radiology NER
pipeline, a BERT NLI checkpoint, distilbert BERTScore) are pluggable
callables so the metrics are testable hermetically and run on whatever
backend the deployment ships — the same optional-sidecar policy as
`clinical.py`.

Document model: a report is a list of sentences; each sentence is a
``Sentence(tokens, entities)`` where ``entities`` are the token texts whose
NER tag is in the radiology target set {S-ANATOMY, S-OBSERVATION}
(`RadEntityMatchExact.py:17`, `:26-34`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple


@dataclass
class Sentence:
    tokens: List[str] = field(default_factory=list)
    entities: List[str] = field(default_factory=list)

    @property
    def text(self) -> str:
        return " ".join(self.tokens)


Doc = List[Sentence]
NerFn = Callable[[Sequence[str]], List[Doc]]
# (premises, hypotheses) -> labels in {"entailment", "neutral", "contradiction"}
NliFn = Callable[[Sequence[str], Sequence[str]], List[str]]
# (cands, refs) -> per-pair similarity F scores
SimFn = Callable[[Sequence[str], Sequence[str]], List[float]]

TARGET_TYPES = ("S-ANATOMY", "S-OBSERVATION")


def _preprocess(text: str) -> str:
    # reference normalization before NER (`RadEntityMatchExact.py:20-21`)
    return text.lower().replace(" .", ".")


def stanza_radiology_ner() -> NerFn:
    """The reference's default NER backend: stanza's `radiology` package
    (`RadEntityMatchExact.py:15-16`). Lazy; raises ImportError with a clear
    message when stanza/model files are absent from the deployment."""
    import stanza  # optional dep

    pipe = stanza.Pipeline(
        lang="en",
        package="radiology",
        processors={"tokenize": "default", "ner": "radiology"},
        tokenize_batch_size=256,
        ner_batch_size=256,
    )

    def run(texts: Sequence[str]) -> List[Doc]:
        stanza_docs = pipe(
            [stanza.Document([], text=_preprocess(t)) for t in texts]
        )
        docs: List[Doc] = []
        for sdoc in stanza_docs:
            doc: Doc = []
            for sentence in sdoc.sentences:
                toks = sentence.to_dict()
                doc.append(Sentence(
                    tokens=[t["text"] for t in toks],
                    entities=[t["text"] for t in toks
                              if t.get("ner") in TARGET_TYPES],
                ))
            docs.append(doc)
        return docs

    return run


def _flat_entities(doc: Doc) -> List[str]:
    return [e for s in doc for e in s.entities]


def rad_entity_match_exact(
    refs: Sequence[str],
    hyps: Sequence[str],
    *,
    ner_fn: NerFn | None = None,
) -> Tuple[float, List[float], List[Doc], List[Doc]]:
    """Exact entity-overlap harmonic mean (`RadEntityMatchExact.py:19-51`).

    Per report: precision = |hyp entities found in ref entities| / |hyp
    entities|; the reference's recall NUMERATOR also iterates the *hyp*
    entities (`:41`, identical to the precision numerator) over the ref
    total — that quirk is kept for parity. Score is the harmonic mean, 0.0
    when either side is 0. Returns (mean, per_sample, docs_h, docs_r) like
    the reference forward so NLI can reuse the parsed docs.
    """
    ner = ner_fn or stanza_radiology_ner()
    docs_h = ner(hyps)
    docs_r = ner(refs)

    scores: List[float] = []
    for doc_h, doc_r in zip(docs_h, docs_r):
        ents_h = _flat_entities(doc_h)
        ents_r = _flat_entities(doc_r)
        match = sum(1.0 for e in ents_h if e in ents_r)
        pr = match / len(ents_h) if ents_h else 0.0
        rc = match / len(ents_r) if ents_r else 0.0
        scores.append(2 * pr * rc / (pr + rc) if pr > 0.0 and rc > 0.0 else 0.0)
    mean = float(sum(scores) / len(scores)) if scores else 0.0
    return mean, scores, docs_h, docs_r


def transformers_nli(model_path: str | None = None, *,
                     batch_size: int = 24) -> NliFn:
    """NLI backend over a local transformers sequence-classification
    checkpoint (env ``RADVLM_NLI_MODEL``). The reference downloads Stanford's
    `model_medrad_19k` BERT-NLI from the hub (`RadEntityNLI.py:24-35`) —
    egress-blocked here, so the checkpoint path is explicit. The model's
    id2label must name entailment/neutral/contradiction."""
    import torch
    from transformers import AutoModelForSequenceClassification, AutoTokenizer

    path = model_path or os.environ.get("RADVLM_NLI_MODEL", "")
    if not path:
        raise ImportError(
            "RadEntityNLI needs an NLI checkpoint: pass model_path or set "
            "RADVLM_NLI_MODEL (the reference uses StanfordAIMI/RRG_scorers "
            "model_medrad_19k)"
        )
    tok = AutoTokenizer.from_pretrained(path)
    model = AutoModelForSequenceClassification.from_pretrained(path).eval()
    id2label = {int(k): v.lower() for k, v in model.config.id2label.items()}

    def run(premises: Sequence[str], hypotheses: Sequence[str]) -> List[str]:
        labels: List[str] = []
        with torch.no_grad():
            for i in range(0, len(premises), batch_size):
                enc = tok(list(premises[i:i + batch_size]),
                          list(hypotheses[i:i + batch_size]),
                          padding=True, truncation=True, max_length=256,
                          return_tensors="pt")
                pred = model(**enc).logits.argmax(-1).tolist()
                labels.extend(id2label[p] for p in pred)
        return labels

    return run


def bertscore_sim() -> SimFn:
    """Sentence-similarity backend: distilbert BERTScore F, rescaled —
    the reference's pair scorer (`RadEntityNLI.py:37-46`)."""
    from bert_score import BERTScorer  # optional dep

    scorer = BERTScorer(model_type="distilbert-base-uncased", num_layers=5,
                        batch_size=64, lang="en", rescale_with_baseline=True)

    def run(cands: Sequence[str], refs: Sequence[str]) -> List[float]:
        _, _, f = scorer.score(cands=list(cands), refs=list(refs),
                               batch_size=64)
        return [float(x) for x in f]

    return run


def rad_entity_nli(
    refs: Sequence[str],
    hyps: Sequence[str],
    *,
    ner_fn: NerFn | None = None,
    nli_fn: NliFn | None = None,
    sim_fn: SimFn | None = None,
) -> Tuple[float, List[float]]:
    """Entity overlap gated by sentence-level NLI (`RadEntityNLI.py:48-126`).

    Per report, per hyp sentence WITH entities: find the most similar ref
    sentence (argmax BERTScore-F over all hyp x ref sentence pairs), run NLI
    with the hyp sentence as premise; 'entailment' adds one bonus match,
    'contradiction' vetoes that sentence's entity matches, and each entity
    also matches when it appears anywhere in the other report's entity list.
    Recall mirrors this with ref sentences against the hyp report. Reports
    where either side parses to zero sentences are SKIPPED (not scored as 0,
    `RadEntityNLI.py:63-64`) — the mean is over the scored subset.
    """
    ner = ner_fn or stanza_radiology_ner()
    nli = nli_fn or transformers_nli()
    sim = sim_fn or bertscore_sim()

    _, _, docs_h, docs_r = rad_entity_match_exact(refs, hyps, ner_fn=ner)

    scores: List[float] = []
    for doc_h, doc_r in zip(docs_h, docs_r):
        hyp_sents = [s.text for s in doc_h]
        ref_sents = [s.text for s in doc_r]
        if not hyp_sents or not ref_sents:
            continue

        # all-pairs similarity, row-major over (hyp, ref)
        pairs_c = [h for h in hyp_sents for _ in ref_sents]
        pairs_r = [r for _ in hyp_sents for r in ref_sents]
        f = sim(pairs_c, pairs_r)
        n_ref = len(ref_sents)

        def row(i: int) -> List[float]:
            return f[i * n_ref:(i + 1) * n_ref]

        def argmax(xs: List[float]) -> int:
            return max(range(len(xs)), key=lambda i: xs[i])

        ents_r_flat = _flat_entities(doc_r)
        ents_h_flat = _flat_entities(doc_h)

        def side(sentences, entity_lists, other_sentences, other_entities,
                 sim_row) -> Tuple[int, int]:
            match, total = 0, 0
            for i, (sent, ents) in enumerate(zip(sentences, entity_lists)):
                if not ents:
                    continue
                j = argmax(sim_row(i))
                label = nli([sent], [other_sentences[j]])[0]
                if label == "entailment":
                    match += 1
                for e in ents:
                    total += 1
                    if label == "contradiction":
                        continue
                    if e in other_entities:
                        match += 1
            return match, total

        match_p, total_p = side(
            hyp_sents, [s.entities for s in doc_h], ref_sents, ents_r_flat,
            row,
        )
        match_r, total_r = side(
            ref_sents, [s.entities for s in doc_r], hyp_sents, ents_h_flat,
            lambda j: [row(i)[j] for i in range(len(hyp_sents))],
        )

        pr = match_p / total_p if total_p > 0 else 0.0
        rc = match_r / total_r if total_r > 0 else 0.0
        scores.append(2 * pr * rc / (pr + rc) if pr > 0.0 and rc > 0.0 else 0.0)

    mean = float(sum(scores) / len(scores)) if scores else 0.0
    return mean, scores


# ---------------------------------------------------------------------------
# Stanford CT-abdomen substring accuracy (pure python, bit-matchable)
# ---------------------------------------------------------------------------

# Label lists are the metric's defining constants
# (`StanfordCTAbdAcc/StanfordCTAbdAcc.py:3-57`).
CT_ABD_LABELS: Dict[str, frozenset] = {
    "radiologist_labels_from_n_grams": frozenset({
        "focal splenic lesions", "pericholecystic fluid",
        "dilated loops of small", "spleen is enlarged , measuring",
        "for biliary duct dilatation", "gallstones without ct",
        "spleen is enlarged", "gallbladder wall thickening",
        "lesion in the pancreatic", "evidence of cholecystitis",
        "surgically absent", "ct evidence of acute cholecystitis",
        "ct evidence of cholecystitis", "thickening or pericholecystic fluid",
        "upper limits of normal", "prostate is mildly enlarged",
        "acute cholecystitis", "thickening or pericholecystic",
        "pancreatic ductal dilatation", "the prostate is mildly",
        "wall thickening", "findings of cholecystitis", "bowel obstruction",
        "the spleen is enlarged", "gallstones", "the upper limits of normal",
        "evidence of acute cholecystitis", "the spleen is enlarged measuring",
        "pancreatic ductal dilation",
        "gallstones no extrahepatic biliary dilatation",
        "wall thickening or pericholecystic",
        "calcification is demonstrated the pancreatic", "of cholecystitis",
        "wall thickening or pericholecystic fluid",
        "the spleen is enlarged ,", "lymphadenopathy by size criteria",
    }),
    "chatgpt_labels_from_n_grams": frozenset({
        "gallbladder wall", "cholecystitis", "pericholecystic fluid",
        "ct findings", "gallstones", "biliary duct dilatation",
        "lymphadenopathy", "prostate", "uterus", "small bowel",
        "bowel obstruction", "seminal vesicles", "right lower quadrant",
        "spleen", "pancreatic duct", "pancreatic ductal dilatation",
        "pancreatic head", "pancreatic tail", "pancreatic body",
        "no focal lesions", "no obstruction", "normal size",
        "normal appearance", "mildly enlarged", "enlarged", "absent",
        "evidence of", "dilated",
    }),
}


def stanford_ct_abd_accuracy(
    refs: Sequence[str], hyps: Sequence[str]
) -> Dict[str, float]:
    """Per-label-list substring accuracy (`StanfordCTAbdAcc.py:62-92`): for
    each (ref, hyp), the fraction of list labels appearing in the ref that
    also appear in the hyp; averaged over refs containing at least one label,
    plus the mean over both lists under 'averaged'."""
    assert len(refs) == len(hyps), "refs and hyps should have the same length"
    scores: Dict[str, float] = {}
    for name, labels in CT_ABD_LABELS.items():
        per_sentence: List[float] = []
        for ref, hyp in zip(refs, hyps):
            in_ref = {label for label in labels if label in ref}
            if in_ref:
                matching = sum(1 for label in in_ref if label in hyp)
                per_sentence.append(matching / len(in_ref))
        scores[name] = (
            sum(per_sentence) / len(per_sentence) if per_sentence else 0
        )
    scores["averaged"] = sum(scores.values()) / len(scores)
    return scores
