"""QA jsonl -> entailment-statement jsonl converters.

Counterpart of qagnn_tpu/preprocess/convert.py, line for line: behavioral
ports of reference utils/convert_csqa.py (wh-word -> blank -> fill
with each choice) and utils/convert_obqa.py (stem + choice concatenation).
The wh-word heuristics below are the reference's contract — the regexes ARE
the spec (reference utils/convert_csqa.py:117-177) — so they are preserved.
"""

from __future__ import annotations

import json
import re

BLANK = "___"
WH_WORDS = ["which", "what", "where", "when", "how", "who", "why"]


def convert_to_entailment(qa_file: str, output_file: str) -> None:
    """CSQA-style conversion (reference utils/convert_csqa.py:45-56)."""
    with open(qa_file) as fin, open(output_file, "w") as fout:
        for line in fin:
            fout.write(json.dumps(
                convert_question_json(json.loads(line))) + "\n")


def convert_to_obqa_statement(qa_file: str, output_file1: str,
                              output_file2: str | None = None) -> None:
    """OBQA-style conversion: statement = stem + ' ' + choice
    (reference utils/convert_obqa.py:12-38)."""
    outs = [open(output_file1, "w")]
    if output_file2:
        outs.append(open(output_file2, "w"))
    try:
        with open(qa_file) as fin:
            for line in fin:
                d = json.loads(line)
                answer = d.get("answerKey", "A")
                d.setdefault("statements", [])
                for choice in d["question"]["choices"]:
                    d["statements"].append({
                        "label": choice["label"] == answer,
                        "statement": d["question"]["stem"] + " "
                        + choice["text"]})
                s = json.dumps(d) + "\n"
                for f in outs:
                    f.write(s)
    finally:
        for f in outs:
            f.close()


def convert_question_json(qa_json: dict) -> dict:
    """Per-question conversion (reference utils/convert_csqa.py:60-71)."""
    stem = qa_json["question"]["stem"]
    answer = qa_json.get("answerKey", "A")
    fitb = get_fitb_from_question(stem)
    qa_json.setdefault("statements", [])
    for choice in qa_json["question"]["choices"]:
        qa_json["statements"].append({
            "label": choice["label"] == answer,
            "statement": create_hypothesis(fitb, choice["text"])})
    return qa_json


def get_fitb_from_question(question_text: str) -> str:
    """Fill-in-the-blank form of the question (reference :78-84)."""
    fitb = replace_wh_word_with_blank(question_text)
    if not re.match(".*_+.*", fitb):
        fitb = re.sub(r"[\.\? ]*$", "", question_text.strip()) + " " + BLANK
    return fitb


def create_hypothesis(fitb: str, choice: str) -> str:
    """Substitute the choice into the blank (reference :88-101)."""
    if ". " + BLANK in fitb or fitb.startswith(BLANK):
        choice = choice[0].upper() + choice[1:]
    else:
        choice = choice.lower()
    if not fitb.endswith(BLANK):
        choice = choice.rstrip(".")
    return re.sub("__+", choice, fitb)


def replace_wh_word_with_blank(question_str: str) -> str:
    """Find the wh-word and blank it out (reference :117-177)."""
    question_str = question_str.replace("What's", "What is")
    question_str = question_str.replace("whats", "what")
    question_str = question_str.replace("U.S.", "US")

    matches: list[tuple[str, int]] = []
    for wh in WH_WORDS:
        if wh == "who" and "people who" in question_str:
            continue
        # wh-word right before a trailing '?' clause wins outright
        m = re.search(wh + r"\?[^\.]*[\. ]*$", question_str.lower())
        if m:
            matches = [(wh, m.start())]
            break
        m = re.search(wh + r"[ ,][^\.]*[\. ]*$", question_str.lower())
        if m:
            matches.append((wh, m.start()))

    if matches:
        matches.sort(key=lambda x: x[1])
        wh, start = matches[0]
        question_str = re.sub(r"\?$", ".", question_str.strip())
        fitb = question_str[:start] + BLANK + question_str[start + len(wh):]
        fitb = fitb.replace(BLANK + " of the following", BLANK)
        return fitb.replace(BLANK + " of these", BLANK)

    if " them called?" in question_str:
        return question_str.replace(" them called?", " " + BLANK + ".")
    if " meaning he was not?" in question_str:
        return question_str.replace(" meaning he was not?",
                                    " he was not " + BLANK + ".")
    if " one of these?" in question_str:
        return question_str.replace(" one of these?", " " + BLANK + ".")
    if re.match(r".*[^\.\?] *$", question_str):
        return question_str + " " + BLANK
    return re.sub(r" this[ \?]", " ___ ", question_str)
