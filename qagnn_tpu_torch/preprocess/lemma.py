"""Self-contained English token normalization for concept grounding.

Counterpart of qagnn_tpu/preprocess/lemma.py, word for word (the word
tables and rules are the grounding contract both packages share).

The reference grounds concepts by matching spaCy LEMMA sequences
(reference utils/grounding.py:48-51,134-216). spaCy and the nltk corpora are
not available in this offline environment, so grounding here normalizes BOTH
sides (concept-vocabulary tokens and sentence tokens) with the same
`normalize()`: an irregular-form table plus conservative suffix rules in the
spirit of the Porter stemmer's step 1. Because both sides pass through the
same function, matching behaves like lemma matching wherever the rules are
consistent; quality differences vs spaCy affect recall slightly, not the
pipeline contract.
"""

from __future__ import annotations

import re

# NLTK's English stopword list (public domain word list), embedded verbatim
# so the pipeline has zero download dependencies.
STOPWORDS = frozenset("""a about above after again against ain all am an and
any are aren aren't as at be because been before being below between both but
by can couldn couldn't d did didn didn't do does doesn doesn't doing don
don't down during each few for from further had hadn hadn't has hasn hasn't
have haven haven't having he her here hers herself him himself his how i if
in into is isn isn't it it's its itself just ll m ma me mightn mightn't more
most mustn mustn't my myself needn needn't no nor not now o of off on once
only or other our ours ourselves out over own re s same shan shan't she she's
should should've shouldn shouldn't so some such t than that that'll the their
theirs them themselves then there these they this those through to too under
until up ve very was wasn wasn't we were weren weren't what when where which
while who whom why will with won won't wouldn wouldn't y you you'd you'll
you're you've your yours yourself yourselves""".split())

# extra stopwords the reference adds for graph pruning
# (reference utils/conceptnet.py:160-162)
EXTRA_STOPWORDS = frozenset(["like", "gone", "did", "going", "would", "could",
                             "get", "in", "up", "may", "wanter"])

# grounding blacklist (reference utils/grounding.py:16-19)
GROUND_BLACKLIST = frozenset([
    "-PRON-", "actually", "likely", "possibly", "want", "make", "my",
    "someone", "sometimes_people", "sometimes", "would", "want_to", "one",
    "something", "everybody", "somebody", "could", "could_be"])

PRONOUNS = frozenset(["my", "you", "it", "its", "your", "i", "he", "she",
                      "his", "her", "they", "them", "their", "our", "we"])

# common irregular forms -> base
IRREGULARS = {
    "ran": "run", "running": "run", "ate": "eat", "eaten": "eat",
    "went": "go", "gone": "go", "goes": "go", "did": "do", "done": "do",
    "said": "say", "made": "make", "making": "make", "took": "take",
    "taken": "take", "taking": "take", "came": "come", "coming": "come",
    "got": "get", "gotten": "get", "getting": "get", "saw": "see",
    "seen": "see", "knew": "know", "known": "know", "thought": "think",
    "found": "find", "gave": "give", "given": "give", "giving": "give",
    "told": "tell", "felt": "feel", "left": "leave", "kept": "keep",
    "held": "hold", "brought": "bring", "bought": "buy", "wrote": "write",
    "written": "write", "writing": "write", "stood": "stand", "sat": "sit",
    "sitting": "sit", "spoke": "speak", "spoken": "speak", "lay": "lie",
    "lying": "lie", "met": "meet", "paid": "pay", "sent": "send",
    "built": "build", "fell": "fall", "fallen": "fall", "flew": "fly",
    "flown": "fly", "drew": "draw", "drawn": "draw", "drove": "drive",
    "driven": "drive", "driving": "drive", "swam": "swim", "sang": "sing",
    "sung": "sing", "ran_out": "run_out", "wore": "wear", "worn": "wear",
    "chose": "choose", "chosen": "choose", "broke": "break",
    "broken": "break", "slept": "sleep", "woke": "wake", "woken": "wake",
    "children": "child", "men": "man", "women": "woman", "people": "person",
    "feet": "foot", "teeth": "tooth", "mice": "mouse", "geese": "goose",
    "lives": "life", "knives": "knife", "wives": "wife", "leaves": "leaf",
    "wolves": "wolf", "shelves": "shelf", "better": "well", "best": "well",
    "worse": "bad", "worst": "bad", "was": "be", "were": "be", "is": "be",
    "are": "be", "am": "be", "been": "be", "being": "be", "has": "have",
    "had": "have", "having": "have", "an": "a",
}

_VOWELS = set("aeiou")


def _has_vowel(s: str) -> bool:
    return any(c in _VOWELS for c in s)


def normalize(token: str) -> str:
    """Map an English token to a canonical base form."""
    t = token.lower()
    if t in IRREGULARS:
        return IRREGULARS[t]
    if len(t) <= 3:
        return t

    # -ies -> -y (cities -> city)
    if t.endswith("ies") and len(t) > 4:
        return t[:-3] + "y"
    # -sses/-shes/-ches/-xes/-zes -> strip es
    if re.search(r"(ss|sh|ch|x|z)es$", t):
        return t[:-2]
    # -s plural (not -ss, -us, -is)
    if t.endswith("s") and not t.endswith(("ss", "us", "is")) and len(t) > 3:
        return t[:-1]
    # -ing
    if t.endswith("ing") and len(t) > 5 and _has_vowel(t[:-3]):
        stem = t[:-3]
        if len(stem) > 2 and stem[-1] == stem[-2] \
                and stem[-1] not in "lsz":            # running -> run
            return stem[:-1]
        if not stem.endswith("e") and _needs_e(stem):  # making handled above
            return stem + "e"
        return stem
    # -ed
    if t.endswith("ed") and len(t) > 4 and _has_vowel(t[:-2]):
        stem = t[:-2]
        if len(stem) > 2 and stem[-1] == stem[-2] and stem[-1] not in "lsz":
            return stem[:-1]
        if _needs_e(stem):
            return stem + "e"
        return stem
    return t


def _needs_e(stem: str) -> bool:
    """Heuristic: restore trailing 'e' after stripping -ing/-ed
    (bake->baking, live->lived): consonant + single vowel + consonant that is
    not w/x/y usually doubles instead; CVCe words end with e."""
    return bool(re.search(r"[^aeiou][aeiou][^aeiouwxy]$", stem)) is False and \
        bool(re.search(r"[aeiou][^aeiou]$", stem))


def tokenize(text: str) -> list[str]:
    """Lowercase word tokenizer (mirrors spaCy's whitespace+punct split
    closely enough for concept matching)."""
    return re.findall(r"[a-zA-Z]+(?:'[a-z]+)?|[0-9]+", text.lower())
