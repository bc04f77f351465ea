"""Synthetic Portuguese sentences with lexical emotion/sentiment supervision
(port of ``msa_tpu/training/text_synth.py``: numpy and ``zlib.crc32``, the
same sentences string for string from the same generator).

The text heads train on procedurally generated sentences whose LEXICON
encodes the label, four tasks matching the text model's heads:

- **emotion** (7-class, the canonical order of ``core/emotions.py``):
  emotion-word lexicons in varied sentence templates;
- **sentiment** (3-class negative/neutral/positive: polarity is
  P(pos) − P(neg));
- **sarcasm** (binary): Brazilian-Portuguese sarcasm markers ("só que
  não", "aham, claro", …) prepended or appended to plain sentences;
- **humor** (binary): laughter/joke markers ("kkk", "haha", "que piada").

Held-out generalization is COMPOSITIONAL: a deterministic quarter of the
(lexicon word × sentence template) grid is reserved for evaluation, so a
held-out sentence pairs a word and a template each seen in training but
never together. An unseen word maps to an arbitrary hashed token id
(the WordPiece tokenizer's hash mode) whose embedding carries no meaning,
so keyword detection invariant to the surrounding sentence is what this
supervision can teach.
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np

# --- lexicons (canonical emotion order: core/emotions.py:24-33) -------------

EMOTION_WORDS: Tuple[Tuple[str, ...], ...] = (
    # neutral
    (
        "normal", "comum", "habitual", "rotineiro", "regular", "típico",
        "neutro", "indiferente", "estável", "moderado", "usual", "corrente",
    ),
    # happy
    (
        "feliz", "alegre", "contente", "animado", "maravilhoso", "ótimo",
        "radiante", "eufórico", "empolgado", "satisfeito", "encantado",
        "festivo", "sorridente", "entusiasmado",
    ),
    # sad
    (
        "triste", "deprimido", "melancólico", "abatido", "desanimado",
        "infeliz", "choroso", "desolado", "amargurado", "angustiado",
        "cabisbaixo", "lamentável",
    ),
    # angry
    (
        "furioso", "irritado", "bravo", "raivoso", "indignado", "revoltado",
        "enfurecido", "nervoso", "irado", "exasperado", "colérico",
        "aborrecido",
    ),
    # fearful
    (
        "assustado", "amedrontado", "apavorado", "aterrorizado", "receoso",
        "temeroso", "ansioso", "inseguro", "alarmado", "apreensivo",
        "horrorizado", "intimidado",
    ),
    # disgusted
    (
        "enojado", "nojento", "repugnante", "asqueroso", "repulsivo",
        "nauseante", "desagradável", "revoltante", "abominável", "imundo",
        "detestável", "horrível",
    ),
    # surprised
    (
        "surpreso", "espantado", "chocado", "atônito", "impressionado",
        "perplexo", "estupefato", "admirado", "boquiaberto", "inesperado",
        "surpreendente", "pasmo",
    ),
)

SENTIMENT_WORDS: Tuple[Tuple[str, ...], ...] = (
    # negative
    (
        "péssimo", "terrível", "horrível", "ruim", "detestável", "odioso",
        "lamentável", "desastroso", "decepcionante", "insuportável",
    ),
    # neutral
    (
        "normal", "comum", "regular", "mediano", "aceitável", "razoável",
        "ordinário", "padrão", "típico", "corriqueiro",
    ),
    # positive
    (
        "excelente", "maravilhoso", "ótimo", "incrível", "fantástico",
        "esplêndido", "perfeito", "admirável", "sensacional", "formidável",
    ),
)

SARCASM_MARKERS: Tuple[str, ...] = (
    "só que não",
    "aham, claro",
    "sei, sei",
    "com certeza, né",
    "que novidade",
    "nossa, que surpresa",
    "até parece",
    "imagina só",
)

HUMOR_MARKERS: Tuple[str, ...] = (
    "kkk",
    "kkkkk",
    "haha",
    "hahaha",
    "rsrs",
    "que piada",
    "morri de rir",
    "muito engraçado",
)

TEMPLATES: Tuple[str, ...] = (
    "Eu estou {adv}{word} hoje.",
    "Que dia {adv}{word}!",
    "Isso me deixa {adv}{word}.",
    "A reunião foi {adv}{word}.",
    "Ele parecia {adv}{word} durante a conversa.",
    "O resultado do projeto ficou {adv}{word}.",
    "Achei o filme {adv}{word}.",
    "Minha reação foi ficar {adv}{word}.",
    "Todo mundo comentou que estava {adv}{word}.",
    "No final, tudo pareceu {adv}{word}.",
    "A notícia de ontem foi {adv}{word}.",
    "Confesso que me senti {adv}{word} com isso.",
)

ADVERBS: Tuple[str, ...] = ("", "muito ", "bastante ", "tão ", "um pouco ")

FILLERS: Tuple[str, ...] = (
    "",
    " Depois conversamos melhor.",
    " Vamos ver o que acontece amanhã.",
    " Foi isso que aconteceu.",
    " Ninguém esperava por isso.",
    " A equipe toda estava presente.",
)


def _holdout_templates(key: str) -> List[int]:
    """Deterministic ~1/4 of template indices reserved for held-out
    sentences of this key (a lexicon word or marker phrase). Guaranteed
    non-empty and proper (both splits keep ≥1 template)."""
    sel = [
        t
        for t in range(len(TEMPLATES))
        if zlib.crc32(f"{key}|{t}".encode()) % 4 == 0
    ]
    if not sel or len(sel) == len(TEMPLATES):
        sel = [zlib.crc32(key.encode()) % len(TEMPLATES)]
    return sel


def _sentence(
    rng: np.random.Generator, word: str, holdout: bool, key: str | None = None
) -> str:
    """One sentence whose (key × template) pair belongs to the requested
    split — key defaults to the lexicon word itself."""
    reserved = _holdout_templates(key if key is not None else word)
    pool = (
        reserved
        if holdout
        else [t for t in range(len(TEMPLATES)) if t not in reserved]
    )
    t = TEMPLATES[pool[rng.integers(0, len(pool))]]
    adv = ADVERBS[rng.integers(0, len(ADVERBS))]
    s = t.format(adv=adv, word=word)
    return s + FILLERS[rng.integers(0, len(FILLERS))]


def emotion_sentences(
    rng: np.random.Generator, n: int, holdout: bool = False
) -> Tuple[List[str], np.ndarray]:
    """(sentences, labels in CANONICAL 7-class order)."""
    labels = rng.integers(0, len(EMOTION_WORDS), size=n).astype(np.int64)
    texts = []
    for y in labels:
        pool = EMOTION_WORDS[int(y)]
        texts.append(
            _sentence(rng, pool[rng.integers(0, len(pool))], holdout)
        )
    return texts, labels


def sentiment_sentences(
    rng: np.random.Generator, n: int, holdout: bool = False
) -> Tuple[List[str], np.ndarray]:
    """(sentences, labels 0=negative 1=neutral 2=positive — the D4-repair
    head order)."""
    labels = rng.integers(0, 3, size=n).astype(np.int64)
    texts = []
    for y in labels:
        pool = SENTIMENT_WORDS[int(y)]
        texts.append(
            _sentence(rng, pool[rng.integers(0, len(pool))], holdout)
        )
    return texts, labels


def _marked_sentences(
    rng: np.random.Generator,
    n: int,
    markers: Tuple[str, ...],
    holdout: bool,
) -> Tuple[List[str], np.ndarray]:
    """Binary task: plain sentence vs the same with a marker (prepended or
    appended). Base sentences draw from every emotion lexicon so the head
    can't key on emotion words; the compositional split keys on the MARKER
    for marked sentences (held-out = seen marker in a sentence template it
    never co-occurred with in training) and on the base word otherwise."""
    labels = rng.integers(0, 2, size=n).astype(np.int64)
    texts = []
    for y in labels:
        klass = EMOTION_WORDS[rng.integers(0, len(EMOTION_WORDS))]
        word = klass[rng.integers(0, len(klass))]
        if y == 1:
            mark = markers[rng.integers(0, len(markers))]
            base = _sentence(rng, word, holdout, key=mark)
            base = (
                f"{mark.capitalize()}, {base[0].lower()}{base[1:]}"
                if rng.uniform() < 0.5
                else f"{base} {mark.capitalize()}."
            )
        else:
            base = _sentence(rng, word, holdout)
        texts.append(base)
    return texts, labels


def sarcasm_sentences(rng, n, holdout=False):
    return _marked_sentences(rng, n, SARCASM_MARKERS, holdout)


def humor_sentences(rng, n, holdout=False):
    return _marked_sentences(rng, n, HUMOR_MARKERS, holdout)


# --- adversarial split: an eval the in-family holdout cannot saturate -------

_OOV_SYLLABLES: Tuple[str, ...] = (
    "bra", "dul", "fen", "gor", "lim", "mok", "nas", "pir", "ruv", "sel",
    "tam", "vex", "zon", "cal", "dri", "fos", "gan", "lup", "mer", "nix",
)


def oov_word(rng: np.random.Generator) -> str:
    """A pseudo-word guaranteed OUT of every training lexicon: its hashed
    WordPiece embedding (the tokenizer's hash mode) is semantic noise."""
    k = int(rng.integers(2, 4))
    return "".join(
        _OOV_SYLLABLES[int(rng.integers(0, len(_OOV_SYLLABLES)))]
        for _ in range(k)
    )


def with_oov_context(
    rng: np.random.Generator, texts: List[str]
) -> List[str]:
    """Label-preserving hard mutation: wrap each sentence in 1–2 leading and
    0–2 trailing OOV pseudo-word sentences. Every ORIGINAL token keeps its
    exact surface form (the tokenizer is cased — mutating case would destroy
    the markers' training-time identity), but the label-bearing words shift
    position and the trunk must ignore unseen-token embeddings that carry
    arbitrary hashed semantics. Real-orthography OOV noise is what field
    text contains and the in-family holdout never exercises."""
    out: List[str] = []
    for s in texts:
        pre = " ".join(oov_word(rng) for _ in range(int(rng.integers(1, 3))))
        post = " ".join(oov_word(rng) for _ in range(int(rng.integers(0, 3))))
        s2 = f"{pre.capitalize()}. {s}"
        if post:
            s2 = f"{s2} {post.capitalize()}."
        out.append(s2)
    return out
