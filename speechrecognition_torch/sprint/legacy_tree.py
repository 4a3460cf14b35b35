"""Legacy phonetic decision-tree loader (the reference's `Legacy/` tier).

Reads the old text format of rwth-asr-0.5/src/Legacy/DecisionTree-legacy.c
(ReadDefFiles + BuildTree) and classifies allophone states like
Legacy/DecisionTree.cc PhoneticDecisionTree::classify:

  file layout (blank-line-separated sections):
    1. phoneme list (one per line; must contain the boundary symbol "#"
       and the silence symbol "si" — DecisionTree-legacy.c:98);
    2. a "phone part" section, skipped until TWO consecutive blank
       lines (ReadDefFiles:377-386);
    3. questions: `NAME pho1 pho2 ...` per line (phoneme-set
       membership);
    4. the tree in pre-order, one node per line `text(args)`:
       3 args `(quest,ctx,number)` or 2 args with alphabetic ctx →
       internal node (ctx `l`→−1, `r`→+1); 2 numeric args or 1 arg →
       leaf whose `quest` field stores CLASS+1 (BuildTree:398-460,
       classify:258 `question - 1`).

  After the file's questions the loader appends the implicitly defined
  ones, preserving index order (GetQuestions:245-337): STATE-0..2,
  position questions per boundary style (none / POSITION-WORD-BOUNDARY /
  {ONE-PHONEME-WORD, POSITION-WORD-BEGINNING, POSITION-WORD-END}), and
  one singleton question per non-silence/non-boundary phoneme.

  classify(): silence-centered allophones short-circuit to the last
  class (n_clusters); otherwise the tree is walked answering phoneme-set
  questions at the node's context position (missing context → the
  boundary phoneme), state-equality and boundary-position questions
  (DecisionTree.cc:172-270, incl. translateBoundaryFlag).

Port: a copy of speechrecognition_tpu/sprint/legacy_tree.py (host code).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, TextIO, Tuple

BOUNDARY_STR = "#"
SILENCE_STR = "si"
N_SEGMENTS = 3

#: translateBoundaryFlag (DecisionTree.cc:211-238): the new-style
#: boundary flags (0 = within word, 1 = word-initial, 2 = word-final,
#: 3 = both) to the legacy per-style codes
_BOUNDARY_STYLES = ("no-pos-dep", "pos-dep", "super-pos-dep")


def _atoi(s: str) -> int:
    """C atoi: parse an optional-signed integer prefix, 0 otherwise."""
    s = s.strip()
    out = ""
    for i, c in enumerate(s):
        if c.isdigit() or (i == 0 and c in "+-"):
            out += c
        else:
            break
    try:
        return int(out)
    except ValueError:
        return 0


@dataclass
class _Question:
    name: str
    type: str                       # "phoneme" | "state" | "position"
    phoneme_set: Optional[set] = None
    state: int = -1
    boundary: int = -1


@dataclass
class _Node:
    question: int
    context: int
    number: int
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None

    @property
    def is_leaf(self) -> bool:
        return self.left is None and self.right is None


class LegacyDecisionTree:
    """Old-format phonetic decision tree with Sprint classify semantics."""

    def __init__(self, phonemes: List[str], questions: List[_Question],
                 root: _Node, n_clusters: int, boundary_style: str):
        self.phonemes = phonemes
        self.phoneme_idx = {p: i for i, p in enumerate(phonemes)}
        self.questions = questions
        self.root = root
        self.n_clusters = n_clusters
        self.boundary_style = boundary_style
        self.boundary_idx = self.phoneme_idx[BOUNDARY_STR]
        self.silence_idx = self.phoneme_idx[SILENCE_STR]

    # -- reading --------------------------------------------------------------

    @staticmethod
    def read(path: str, boundary_style: str = "no-pos-dep",
             ) -> "LegacyDecisionTree":
        if boundary_style not in _BOUNDARY_STYLES:
            raise ValueError(f"unknown boundary style {boundary_style!r}")
        with open(path) as f:
            phonemes = LegacyDecisionTree._read_phonemes(f)
            LegacyDecisionTree._skip_phone_part(f)
            questions = LegacyDecisionTree._read_questions(
                f, phonemes, boundary_style)
            root, n_clusters = LegacyDecisionTree._build_tree(f)
        if root is None:
            raise ValueError(f"{path}: no tree section")
        return LegacyDecisionTree(phonemes, questions, root, n_clusters,
                                  boundary_style)

    @staticmethod
    def _read_phonemes(f: TextIO) -> List[str]:
        phonemes: List[str] = []
        for line in f:
            if line == "\n":
                break
            tok = line.split()
            if tok:
                phonemes.append(tok[0])
        if BOUNDARY_STR not in phonemes:
            raise ValueError("boundary not defined")       # legacy error()
        if SILENCE_STR not in phonemes:
            raise ValueError("silence not defined")
        return phonemes

    @staticmethod
    def _skip_phone_part(f: TextIO) -> None:
        count = 0
        while count < 2:
            line = f.readline()
            if not line:
                break
            count = count + 1 if line == "\n" else 0

    @staticmethod
    def _read_questions(f: TextIO, phonemes: Sequence[str],
                        boundary_style: str) -> List[_Question]:
        questions: List[_Question] = []
        for line in f:
            if line == "\n" or not line.strip():
                break
            toks = line.split()
            name, members = toks[0], toks[1:]
            pset = set()
            for t in members:
                if t not in phonemes:
                    raise ValueError(f"Can't find phoneme {t} "
                                     f"in phoneme list")
                pset.add(t)
            questions.append(_Question(name=name, type="phoneme",
                                       phoneme_set=pset))
        # implicit questions, exact append order (GetQuestions:245-337)
        for s in range(N_SEGMENTS):
            questions.append(_Question(name=f"STATE-{s}", type="state",
                                       state=s))
        if boundary_style == "pos-dep":
            questions.append(_Question(name="POSITION-WORD-BOUNDARY",
                                       type="position", boundary=1))
        elif boundary_style == "super-pos-dep":
            for name, b in (("ONE-PHONEME-WORD", 1),
                            ("POSITION-WORD-BEGINNING", 2),
                            ("POSITION-WORD-END", 3)):
                questions.append(_Question(name=name, type="position",
                                           boundary=b))
        for p in phonemes:
            if p not in (SILENCE_STR, BOUNDARY_STR):
                questions.append(_Question(name=p, type="phoneme",
                                           phoneme_set={p}))
        return questions

    @staticmethod
    def _parse_node_line(line: str) -> Optional[List[str]]:
        """`%*[^(](a1,a2,a3)` — args between the first parens."""
        i = line.find("(")
        j = line.find(")", i)
        if i < 0 or j < 0:
            return None
        return [a.strip() for a in line[i + 1:j].split(",")]

    @staticmethod
    def _build_tree(f: TextIO) -> Tuple[Optional[_Node], int]:
        def build() -> Tuple[Optional[_Node], int]:
            line = f.readline()
            if not line:
                return None, 0
            args = LegacyDecisionTree._parse_node_line(line)
            if not args:
                return None, -1
            if len(args) == 3 or (len(args) == 2 and args[1][:1].isalpha()):
                ctx_raw = args[1]
                if ctx_raw[:1] == "l":
                    ctx = -1
                elif ctx_raw[:1] == "r":
                    ctx = 1
                else:
                    ctx = _atoi(ctx_raw)    # C atoi: "c"/center → 0
                number = _atoi(args[2]) if len(args) == 3 else 0
                node = _Node(question=int(args[0]), context=ctx,
                             number=number)
                node.left, max_a = build()
                node.right, max_b = build()
                return node, max(max_a, max_b)
            # leaf: question field stores class+1
            q = int(args[0])
            number = int(args[1]) if len(args) == 2 else 0
            return _Node(question=q, context=0, number=number), q

        return build()

    # -- classification -------------------------------------------------------

    @property
    def num_classes(self) -> int:
        return self.n_clusters + 1          # + the silence class

    def translate_boundary(self, flag: int) -> int:
        """New-style boundary flag (0 within / 1 initial / 2 final /
        3 both) → legacy code per style (DecisionTree.cc:211-238)."""
        if self.boundary_style == "no-pos-dep":
            return 0
        if self.boundary_style == "pos-dep":
            return 0 if flag == 0 else 1
        return {0: 0, 1: 2, 2: 3, 3: 1}[flag]

    def _answer(self, q: _Question, context: int,
                phones: Dict[int, Optional[str]], state: int,
                boundary: int) -> bool:
        if q.type == "phoneme":
            sym = phones.get(context)
            pho = (self.boundary_idx if sym is None
                   else self.phoneme_idx.get(sym))
            if pho is None:
                raise ValueError(f"phoneme {sym!r} cannot be classified")
            return self.phonemes[pho] in q.phoneme_set
        if q.type == "state":
            return q.state == state
        return q.boundary == boundary

    def classify(self, center: str, state: int, left: Optional[str] = None,
                 right: Optional[str] = None, boundary_flag: int = 0) -> int:
        """Tied class of an allophone state (DecisionTree.cc:244-270):
        silence-centered → the last class; else walk the tree (yes →
        left child)."""
        if center == SILENCE_STR:
            return self.n_clusters
        phones = {0: center, -1: left, 1: right}
        boundary = self.translate_boundary(boundary_flag)
        node = self.root
        while not node.is_leaf:
            q = self.questions[node.question]
            if self._answer(q, node.context, phones, state, boundary):
                node = node.left
            else:
                node = node.right
        return node.question - 1

    # -- draw (DecisionTree.cc:237-298 dot export) ----------------------------

    def draw(self, out) -> None:
        out.write('digraph "legacy-decision-tree" {\n'
                  'node [fontname="Helvetica"]\n'
                  'edge [fontname="Helvetica"]\n')
        stack = [self.root]
        while stack:
            node = stack.pop()
            if not node.is_leaf:
                q = self.questions[node.question]
                out.write(f'n{id(node)} [label="{node.number}\\n{q.name}'
                          f'\\ncontext: {node.context}"]\n')
                out.write(f'n{id(node)} -> n{id(node.left)} '
                          f'[label="yes"]\n')
                out.write(f'n{id(node)} -> n{id(node.right)} '
                          f'[label="no"]\n')
                stack.append(node.left)
                stack.append(node.right)
            else:
                out.write(f'n{id(node)} [shape=box label="{node.number}'
                          f'\\nclass: {node.question - 1}"]\n')
        out.write("}\n")
