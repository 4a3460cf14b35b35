"""Legacy decision tree → Sprint CART XML conversion.

Counterpart of the reference's Tools/Cart/CartConverter.py: reads the
old ReadDefFiles/BuildTree text format (sprint/legacy_tree.py) and
emits the new XML decision-tree format (sprint/cart.py reads it,
sprint/cart_train.write_tree_xml writes it), preserving classification
semantics exactly:

  * legacy question contexts −1/0/+1 → keys history[0]/central/future[0]
    (CartConverter.py _contexts);
  * state questions → key hmm-state, value = the state index;
  * position questions → key boundary, values from the boundary-style
    position-name table (superPosDep: single-phoneme-lemma /
    begin-of-lemma / end-of-lemma — CartConverter.py _positions);
  * yes → left child in both formats;
  * the legacy silence special case (classify() returns n_clusters
    without walking the tree) becomes an explicit root question
    `central ∈ {silence}` with a leaf carrying class n_clusters.

Equivalence is property-tested in tests/test_tools_tail.py: the
converted XML classifies every random allophone state exactly like the
legacy loader.

Port: a copy of speechrecognition_tpu/sprint/cart_convert.py (host code).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .cart import DecisionTree, Question, TreeNode
from .legacy_tree import SILENCE_STR, LegacyDecisionTree

#: boundary-position value names by translated boundary index
#: (CartConverter.py superPosDep _positions, prefixed by the
#: within-lemma default the Am layer uses for flag 0)
SUPER_POS_DEP = ["within-lemma", "single-phoneme-lemma",
                 "begin-of-lemma", "end-of-lemma"]

_CONTEXT_KEY = {-1: "history[0]", 0: "central", 1: "future[0]"}


def convert_legacy_tree(legacy: LegacyDecisionTree,
                        positions: Optional[Sequence[str]] = None,
                        ) -> DecisionTree:
    """LegacyDecisionTree → cart.DecisionTree with identical classify
    decisions (via the documented property mapping)."""
    positions = list(positions or SUPER_POS_DEP)
    questions: List[Question] = []

    def add_question(q) -> int:
        questions.append(q)
        return len(questions) - 1

    def convert(node) -> TreeNode:
        if node.is_leaf:
            # legacy leaf class = question field − 1
            return TreeNode(id=node.question - 1)
        lq = legacy.questions[node.question]
        if lq.type == "phoneme":
            q = Question(key=_CONTEXT_KEY[node.context],
                         values=frozenset(lq.phoneme_set),
                         description=lq.name)
        elif lq.type == "state":
            q = Question(key="hmm-state", values=frozenset([str(lq.state)]),
                         description=lq.name)
        elif lq.type == "position":
            q = Question(key="boundary",
                         values=frozenset([positions[lq.boundary]]),
                         description=lq.name)
        else:
            raise ValueError(f"unknown legacy question type {lq.type!r}")
        n = TreeNode(id=add_question(q))
        n.left = convert(node.left)      # yes → left in both formats
        n.right = convert(node.right)
        return n

    body = convert(legacy.root)
    # silence special case → explicit root split
    sil_q = TreeNode(id=add_question(Question(
        key="central", values=frozenset([SILENCE_STR]),
        description="silence")))
    sil_q.left = TreeNode(id=legacy.n_clusters)
    sil_q.right = body

    value_maps: Dict[str, Dict[str, int]] = {
        key: {p: i for i, p in enumerate(legacy.phonemes)}
        for key in ("history[0]", "central", "future[0]")}
    value_maps["boundary"] = {p: i for i, p in enumerate(positions)}
    value_maps["hmm-state"] = {str(s): s for s in range(6)}
    return DecisionTree(questions=questions, root=sil_q,
                        value_maps=value_maps)


def legacy_props(center: str, state: int, left: Optional[str],
                 right: Optional[str], boundary_flag: int,
                 legacy: LegacyDecisionTree,
                 positions: Optional[Sequence[str]] = None,
                 ) -> Dict[str, str]:
    """The property dict under which the converted tree reproduces
    legacy.classify(center, state, left, right, boundary_flag)."""
    positions = list(positions or SUPER_POS_DEP)
    return {
        "central": center,
        "history[0]": left if left is not None else "#",
        "future[0]": right if right is not None else "#",
        "hmm-state": str(state),
        "boundary": positions[legacy.translate_boundary(boundary_flag)],
    }
