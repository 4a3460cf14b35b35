"""CART decision trees for phonetic state tying (rwth-asr-0.5/src/Cart/).

Reads the XML format written by Sprint's DecisionTree (questions keyed on
properties like hmm-state, boundary, central, history[0], future[0]) and
classifies property maps by walking the binary tree: internal node ids
index the question list, TRUE → left child, FALSE/UNDEF → right child,
leaf ids are the tied classes (Cart/DecisionTree.cc:218-236).

For device-side use, ``tying_table`` enumerates all (central, history,
future, state, boundary) combinations into a dense int32 lookup so the
tree never has to be walked inside a jitted program.

Port: a copy of speechrecognition_tpu/sprint/cart.py (host code).
"""

from __future__ import annotations

import gzip
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Question:
    key: str
    values: frozenset  # of strings
    description: str = ""


@dataclass
class TreeNode:
    id: int
    left: Optional["TreeNode"] = None
    right: Optional["TreeNode"] = None

    @property
    def is_leaf(self) -> bool:
        return self.left is None and self.right is None


@dataclass
class DecisionTree:
    questions: List[Question]
    root: TreeNode
    value_maps: Dict[str, Dict[str, int]] = field(default_factory=dict)

    @staticmethod
    def read(path: str) -> "DecisionTree":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            tree = ET.parse(f)
        root_el = tree.getroot()

        value_maps: Dict[str, Dict[str, int]] = {}
        props = root_el.find("properties-definition")
        if props is not None:
            current_key = None
            for child in props:
                if child.tag == "key":
                    current_key = (child.text or "").strip()
                elif child.tag == "value-map" and current_key:
                    vm = {}
                    for v in child.findall("value"):
                        vm[(v.text or "").strip()] = int(v.get("id"))
                    value_maps[current_key] = vm

        questions: List[Question] = []
        for q in root_el.find("questions").iter("question"):
            key = (q.findtext("key") or "").strip()
            single = q.findtext("value")
            multi = q.findtext("values")
            if single is not None:
                vals = frozenset([single.strip()])
            elif multi is not None:
                vals = frozenset(multi.split())
            else:
                vals = frozenset()
            questions.append(Question(key=key, values=vals,
                                      description=q.get("description", "")))

        def parse_node(el) -> TreeNode:
            children = el.findall("node")
            node = TreeNode(id=int(el.get("id")))
            if children:
                if len(children) != 2:
                    raise ValueError("binary tree node must have 0 or 2 children")
                node.left = parse_node(children[0])
                node.right = parse_node(children[1])
            return node

        bt = root_el.find("binary-tree")
        root = parse_node(bt.find("node"))
        return DecisionTree(questions=questions, root=root, value_maps=value_maps)

    # -- classification ------------------------------------------------------

    def classify(self, props: Dict[str, str]) -> int:
        node = self.root
        while not node.is_leaf:
            q = self.questions[node.id]
            val = props.get(q.key)
            node = node.left if (val is not None and val in q.values) else node.right
        return node.id

    def num_leaves(self) -> int:
        count = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.is_leaf:
                count += 1
            else:
                stack.extend([n.left, n.right])
        return count

    def max_leaf_id(self) -> int:
        best = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.is_leaf:
                best = max(best, n.id)
            else:
                stack.extend([n.left, n.right])
        return best

    # -- dense tying table for device use ------------------------------------

    def tying_table(self, phonemes: Sequence[str], num_states: int = 3,
                    boundaries: Sequence[str] = ("within-lemma",),
                    ) -> np.ndarray:
        """int32 [n_hist, n_central, n_future, num_states] of tied class ids
        for every triphone state; history/future index 0 = '#' (boundary)."""
        ctx = ["#"] + list(phonemes)
        P = len(phonemes)
        C = len(ctx)
        out = np.zeros((C, P, C, num_states), dtype=np.int32)
        for hi, h in enumerate(ctx):
            for ci, cph in enumerate(phonemes):
                for fi, fut in enumerate(ctx):
                    for s in range(num_states):
                        props = {"central": cph, "history[0]": h,
                                 "future[0]": fut, "hmm-state": str(s),
                                 "boundary": boundaries[0]}
                        out[hi, ci, fi, s] = self.classify(props)
        return out
