"""Bliss XML corpus and lexicon readers (rwth-asr-0.5/src/Bliss/).

Covers the subset exercised by the lab setups: phoneme inventories,
lemmata with orthographic forms and phoneme pronunciations (including
special lemmata like [SILENCE] with empty/«special» orth), and corpora of
recordings/segments with orthographic transcriptions.

Port: a copy of speechrecognition_tpu/sprint/bliss.py (host code).
"""

from __future__ import annotations

import gzip
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Lemma:
    orth: List[str]                  # orthographic forms
    pronunciations: List[List[str]]  # phoneme sequences
    special: Optional[str] = None    # e.g. "silence", "unknown"


@dataclass
class BlissLexicon:
    phonemes: List[str]
    phoneme_index: Dict[str, int]
    lemmas: List[Lemma]
    orth_map: Dict[str, int]         # orth → lemma index

    @staticmethod
    def read(path: str) -> "BlissLexicon":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            tree = ET.parse(f)
        root = tree.getroot()

        phonemes: List[str] = []
        for ph in root.findall("./phoneme-inventory/phoneme"):
            sym = ph.findtext("symbol", "").strip()
            if sym:
                phonemes.append(sym)

        lemmas: List[Lemma] = []
        orth_map: Dict[str, int] = {}
        for lm in root.findall("./lemma"):
            orths = [o.text.strip() if o.text else "" for o in lm.findall("orth")]
            prons = []
            for ph in lm.findall("phon"):
                text = (ph.text or "").strip()
                if text:
                    prons.append(text.split())
            special = lm.get("special")
            idx = len(lemmas)
            lemmas.append(Lemma(orth=orths, pronunciations=prons, special=special))
            for o in orths:
                if o and o not in orth_map:
                    orth_map[o] = idx
        return BlissLexicon(
            phonemes=phonemes,
            phoneme_index={p: i for i, p in enumerate(phonemes)},
            lemmas=lemmas, orth_map=orth_map)

    def lemma_of(self, orth: str) -> Optional[Lemma]:
        i = self.orth_map.get(orth)
        return self.lemmas[i] if i is not None else None

    @property
    def silence_lemma(self) -> Optional[Lemma]:
        for lm in self.lemmas:
            if lm.special == "silence":
                return lm
        return None

    @property
    def num_phonemes(self) -> int:
        return len(self.phonemes)


@dataclass
class BlissSegment:
    name: str
    recording: str
    start: float
    end: float
    orth: List[str]


@dataclass
class BlissCorpus:
    name: str
    segments: List[BlissSegment] = field(default_factory=list)

    @staticmethod
    def read(path: str) -> "BlissCorpus":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            tree = ET.parse(f)
        root = tree.getroot()
        corpus = BlissCorpus(name=root.get("name", ""))
        for rec in root.findall(".//recording"):
            rec_name = rec.get("name", "")
            for seg in rec.findall("segment"):
                orth = (seg.findtext("orth") or "").split()
                start = seg.get("start", "0.0")
                end = seg.get("end", "inf")
                corpus.segments.append(BlissSegment(
                    name=seg.get("name", ""), recording=rec_name,
                    start=float(start), end=float(end), orth=orth))
        return corpus

    def full_segment_name(self, seg: BlissSegment) -> str:
        """The archive key convention: corpus/recording/segment."""
        return f"{self.name}/{seg.recording}/{seg.name}"
