"""Versioned text normalization for evaluation.

Behavioural parity with the reference's vocab specs and ``normalize_text``
(src/whisper_finetune/eval/utils.py:10-111): four character-vocabulary
versions (v0 lowercase ASCII + äöü + digits ... v3 mixed-case with
punctuation), diacritic/ß/dash replacement tables, and the normalize pipeline
lowercase -> char replacement -> whitespace collapse -> vocab filter ->
collapse -> strip. The evaluator hardcodes v0 (reference evaluator.py:101).

Tables are stored as compact replacement-pair strings and expanded at import;
the semantic content (which characters map where, which survive the filter)
must match the reference exactly for WER parity.
"""

from __future__ import annotations

import re
import string
from typing import Dict, Set

_WS = re.compile(r"[ \t]+")

# "source>replacement" pairs, space-separated.
_BASE_REPLACEMENTS = (
    "á>a à>a â>a ç>c é>e è>e ê>e í>i ì>i î>i ñ>n "
    "ó>o ò>o ô>o ú>u ù>u û>u ș>s ş>s"
)
_V3_REPLACEMENTS = (
    "ß>ss ç>c á>a à>a â>a é>e è>e ê>e í>i ì>i î>i "
    "ó>o ò>o ô>o ú>u ù>u û>u ñ>n ș>s –>- \xad>-"
)


def _pairs(spec: str) -> Dict[str, str]:
    out = {}
    for item in spec.split():
        src, dst = item.split(">")
        out[src] = dst
    return out


def _build_lookup_v0() -> Dict[str, str]:
    table = _pairs(_BASE_REPLACEMENTS)
    table["ß"] = "ss"
    # dashes and slashes are inconsistently used upstream; treat as spaces
    table["-"] = " "
    table["–"] = " "
    table["/"] = " "
    return table


_LOOKUP_V0 = _build_lookup_v0()
_LOOKUP_V1 = {**_LOOKUP_V0, **{k.upper(): v.upper() for k, v in _LOOKUP_V0.items()}}
_LOOKUP_V3 = _pairs(_V3_REPLACEMENTS)

_UMLAUTS = "äöü"

VOCAB_SPECS: Dict[str, Dict] = {
    "v0": {
        "char_vocab": set(string.ascii_lowercase + string.digits + _UMLAUTS + " "),
        "char_lookup": _LOOKUP_V0,
        "transform_lowercase": True,
    },
    "v1": {
        "char_vocab": set(
            string.ascii_letters + string.digits + _UMLAUTS + _UMLAUTS.upper() + " .,:"
        ),
        "char_lookup": _LOOKUP_V1,
        "transform_lowercase": False,
    },
    "v2": {
        "char_vocab": set(string.ascii_lowercase + string.digits + _UMLAUTS + " .,:"),
        "char_lookup": _LOOKUP_V1,
        "transform_lowercase": False,
    },
    "v3": {
        "char_vocab": set(
            string.ascii_letters + string.digits + _UMLAUTS + _UMLAUTS.upper() + " .,:-?!;"
        ),
        "char_lookup": _LOOKUP_V3,
        "transform_lowercase": False,
    },
}


def normalize_text(
    text: str,
    char_vocab: Set[str],
    char_lookup: Dict[str, str],
    transform_lowercase: bool = True,
) -> str:
    if transform_lowercase:
        text = text.lower()
    for src, dst in char_lookup.items():
        text = text.replace(src, dst)
    text = _WS.sub(" ", text)
    text = "".join(c for c in text if c in char_vocab)
    text = _WS.sub(" ", text)
    return text.strip()
