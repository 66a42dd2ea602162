"""Caption metrics: PTB-style tokenization + BLEU / ROUGE-L / CIDEr.

The reference scores captions with pycocoevalcap (Java PTBTokenizer +
Bleu(4)/METEOR/ROUGE_L/CIDEr; reference: data/utils.py:175-221,
eval_video_captioning_results.py:74-144). This module implements the same
metrics in pure Python so evaluation runs in offline/Java-less
environments; when pycocoevalcap is importable it is used instead for
bit-identical numbers (including METEOR, which needs the Java jar).

Formulas follow the canonical implementations:
* BLEU-n: corpus-level, clipped n-gram precision, 'closest' effective
  reference length, brevity penalty (Papineni et al.; pycocoevalcap Bleu).
* ROUGE-L: LCS F-measure with beta=1.2, max over references (Lin 2004).
* CIDEr: tf-idf weighted n-gram cosine, n=1..4, gaussian length penalty
  sigma=6 (Vedantam et al. 2015; the CIDEr-D variant pycocoevalcap uses).
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict

# PTBTokenizer-equivalent: lowercase, strip punctuation tokens the Stanford
# tokenizer removes, split on whitespace
_PTB_PUNCT = re.compile(
    r"[\"'`‘’“”(){}\[\]<>@#$%^&*\\/+=|~;:!?.,-]|\.\.\."
)


def ptb_tokenize(caption: str) -> list[str]:
    s = caption.lower()
    s = _PTB_PUNCT.sub(" ", s)
    return s.split()


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def bleu(gts: dict, res: dict, n_max: int = 4):
    """Corpus BLEU-1..n. gts/res: {key: [token lists]} (res has 1 each)."""
    tiny, small = 1e-15, 1e-9
    total_hyp_len = 0
    total_ref_len = 0
    correct = [0] * n_max
    guess = [0] * n_max
    for key in gts:
        hyp = res[key][0]
        refs = gts[key]
        total_hyp_len += len(hyp)
        # 'closest' effective reference length
        total_ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, n_max + 1):
            hyp_ngrams = _ngrams(hyp, n)
            max_ref = Counter()
            for r in refs:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            guess[n - 1] += max(0, len(hyp) - n + 1)
            correct[n - 1] += sum(min(c, max_ref[ng]) for ng, c in hyp_ngrams.items())

    bleus = []
    log_sum = 0.0
    ratio = total_hyp_len / (total_ref_len + tiny)
    bp = 1.0 if ratio > 1.0 else math.exp(1.0 - 1.0 / (ratio + tiny))
    for n in range(n_max):
        p_n = (correct[n] + tiny) / (guess[n] + small)
        log_sum += math.log(p_n)
        bleus.append(bp * math.exp(log_sum / (n + 1)))
    return bleus


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs_len(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, start=1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[len(b)]


def rouge_l(gts: dict, res: dict, beta: float = 1.2) -> float:
    scores = []
    for key in gts:
        hyp = res[key][0]
        best = 0.0
        for ref in gts[key]:
            lcs = _lcs_len(hyp, ref)
            if lcs == 0:
                continue
            prec = lcs / len(hyp) if hyp else 0.0
            rec = lcs / len(ref) if ref else 0.0
            if prec and rec:
                f = ((1 + beta**2) * prec * rec) / (rec + beta**2 * prec)
                best = max(best, f)
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------

def cider(gts: dict, res: dict, n_max: int = 4, sigma: float = 6.0) -> float:
    # document frequencies over the reference corpus
    doc_freq = [defaultdict(int) for _ in range(n_max)]
    for key in gts:
        for n in range(n_max):
            seen = set()
            for ref in gts[key]:
                seen |= set(_ngrams(ref, n + 1).keys())
            for ng in seen:
                doc_freq[n][ng] += 1
    log_ref = math.log(max(len(gts), 1))

    def tfidf_vec(tokens):
        vecs, norms = [], []
        for n in range(n_max):
            counts = _ngrams(tokens, n + 1)
            vec = {}
            norm = 0.0
            for ng, c in counts.items():
                df = math.log(max(doc_freq[n][ng], 1.0))
                w = c * max(log_ref - df, 0.0)
                vec[ng] = w
                norm += w * w
            vecs.append(vec)
            norms.append(math.sqrt(norm))
        return vecs, norms

    scores = []
    for key in gts:
        hyp = res[key][0]
        h_vecs, h_norms = tfidf_vec(hyp)
        score = [0.0] * n_max
        for ref in gts[key]:
            r_vecs, r_norms = tfidf_vec(ref)
            delta = len(hyp) - len(ref)
            for n in range(n_max):
                # CIDEr-D: clip hyp counts at ref counts
                num = sum(min(w, r_vecs[n].get(ng, 0.0)) * r_vecs[n].get(ng, 0.0)
                          for ng, w in h_vecs[n].items())
                if h_norms[n] and r_norms[n]:
                    s = num / (h_norms[n] * r_norms[n])
                else:
                    s = 0.0
                s *= math.exp(-(delta**2) / (2 * sigma**2))
                score[n] += s
        n_refs = len(gts[key])
        scores.append(10.0 * sum(s / n_refs for s in score) / n_max)
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# METEOR (approximate: exact + stem matching only)
# ---------------------------------------------------------------------------

_STEMMER = None


def _porter_stem(word: str) -> str:
    """Porter-stem via nltk (pure Python, no data files); identity fallback."""
    global _STEMMER
    if _STEMMER is None:
        try:
            from nltk.stem.porter import PorterStemmer

            _STEMMER = PorterStemmer()
        except Exception:  # pragma: no cover - nltk is baked into this env
            class _Identity:
                def stem(self, w):
                    return w

            _STEMMER = _Identity()
    return _STEMMER.stem(word)


def _meteor_align(hyp: list[str], ref: list[str]):
    """Greedy two-stage word alignment: exact first, then Porter-stem.

    Greedy discipline (pinned by the nltk oracle in tests): hypothesis
    words are taken LAST-to-first, each matched to the LATEST still-unused
    reference word with the same key, each word used at most once — so a
    repeated hypothesis word pairs with the nearest-from-the-end duplicate
    and contiguous tails stay in one chunk. nltk's ``meteor_score`` with a
    synsets-free wordnet stub runs the same staging and is the independent
    oracle. The synonym stage of real METEOR is omitted (WordNet data
    unavailable offline). Returns (hyp_idx, ref_idx) sorted by hyp index.
    """
    hyp_left = list(enumerate(hyp))
    ref_left = list(enumerate(ref))
    matches = []
    for keyfn in (lambda w: w, _porter_stem):
        next_hyp, next_ref = [], list(ref_left)
        for hi, hw in reversed(hyp_left):
            hk = keyfn(hw)
            for rj in range(len(next_ref) - 1, -1, -1):
                if keyfn(next_ref[rj][1]) == hk:
                    matches.append((hi, next_ref[rj][0]))
                    del next_ref[rj]
                    break
            else:
                next_hyp.append((hi, hw))
        hyp_left, ref_left = next_hyp[::-1], next_ref
    return sorted(matches)


def _meteor_sentence(hyp: list[str], ref: list[str],
                     alpha: float = 0.9, beta: float = 3.0,
                     gamma: float = 0.5) -> float:
    """Single-sentence METEOR with exact+stem matching.

    Classic METEOR scoring (Banerjee & Lavie 2005): unigram F-mean
    weighted toward recall (alpha) discounted by a fragmentation penalty
    gamma*(chunks/matches)^beta. Parameters are the METEOR-1.0 defaults
    (alpha=.9, beta=3, gamma=.5) — NOT the meteor-1.5 jar's tuned
    parameters — so values are not comparable to pycocoevalcap METEOR.
    """
    matches = _meteor_align(hyp, ref)
    m = len(matches)
    if m == 0:
        return 0.0
    precision = m / len(hyp)
    recall = m / len(ref)
    fmean = precision * recall / (alpha * precision + (1 - alpha) * recall)
    chunks = 1
    for (h0, r0), (h1, r1) in zip(matches, matches[1:]):
        if h1 != h0 + 1 or r1 != r0 + 1:
            chunks += 1
    penalty = gamma * (chunks / m) ** beta
    return fmean * (1.0 - penalty)


def meteor_approx(gts: dict, res: dict) -> float:
    """Corpus METEOR approximation: per-key best reference, mean over keys.

    Approximate on three axes, hence reported under the distinct key
    ``METEOR_approx`` (never as the reference's ``METEOR``): (1) exact +
    Porter-stem matching only — no WordNet synonym / paraphrase stages
    (their data is unavailable offline); (2) METEOR-1.0 parameters, not
    the meteor-1.5 jar's; (3) corpus score is the mean of segment scores
    rather than the jar's aggregated-statistics score. The reference's
    exact METEOR comes from pycocoevalcap's Java jar (data/utils.py:208).
    """
    scores = [
        max((_meteor_sentence(res[key][0], r) for r in gts[key]), default=0.0)
        for key in res if key in gts
    ]
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# top-level scorer
# ---------------------------------------------------------------------------

def compute_caption_scores(gts_raw: dict, res_raw: dict) -> dict:
    """gts_raw: {key: [ref strings]}, res_raw: {key: [hyp string]}.

    Uses pycocoevalcap when importable (incl. METEOR); else the pure-Python
    implementations above (METEOR omitted).
    """
    try:  # pragma: no cover - optional dependency
        from pycocoevalcap.bleu.bleu import Bleu
        from pycocoevalcap.cider.cider import Cider
        from pycocoevalcap.meteor.meteor import Meteor
        from pycocoevalcap.rouge.rouge import Rouge
        from pycocoevalcap.tokenizer.ptbtokenizer import PTBTokenizer

        tok = PTBTokenizer()
        gts = tok.tokenize({k: [{"caption": c} for c in v] for k, v in gts_raw.items()})
        res = tok.tokenize({k: [{"caption": c} for c in v] for k, v in res_raw.items()})
        out = {}
        bleu_scores, _ = Bleu(4).compute_score(gts, res)
        for i, s in enumerate(bleu_scores):
            out[f"Bleu_{i+1}"] = s
        out["METEOR"], _ = Meteor().compute_score(gts, res)
        out["ROUGE_L"], _ = Rouge().compute_score(gts, res)
        out["CIDEr"], _ = Cider().compute_score(gts, res)
        return out
    except Exception:
        gts = {k: [ptb_tokenize(c) for c in v] for k, v in gts_raw.items()}
        res = {k: [ptb_tokenize(c) for c in v] for k, v in res_raw.items()}
        out = {}
        for i, s in enumerate(bleu(gts, res)):
            out[f"Bleu_{i+1}"] = s
        # METEOR needs pycocoevalcap's Java jar (WordNet synonym/paraphrase
        # matching); reporting an approximation under the reference's metric
        # name would mislead, so its absence is explicit (reference reports
        # Bleu/METEOR/ROUGE_L/CIDEr, data/utils.py:205-216). An exact+stem
        # approximation is reported alongside under a distinct key.
        out["METEOR"] = None
        out["METEOR_approx"] = meteor_approx(gts, res)
        out["ROUGE_L"] = rouge_l(gts, res)
        out["CIDEr"] = cider(gts, res)
        return out
