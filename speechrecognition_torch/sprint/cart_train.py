"""CART decision-tree training for phonetic state tying.

Counterpart of the reference's trainer stack
(rwth-asr-0.5/src/Cart/DecisionTreeTrainer.cc:324-700 greedy training
loop, Speech/DecisionTreeTrainer.cc:109-201 Gaussian log-likelihood gain
scorer, Speech/DecisionTreeTrainer.cc FeatureAccumulator example
collection).  Same math, different shape: instead of walking example
pointer lists per question, each step pre-computes a boolean answer
matrix ans[Q, E] (question q true for example e) once, and a node's Q
candidate splits are scored in one batched pass

    left_stats[Q, D]  = (ans * member)[Q, E] @ sums[E, D]      (matmul)
    ll[Q]             = 0.5 n (D + D log 2pi + sum_d log var_d)

which is the MXU-shaped formulation of the reference's per-question
example partition loop (DecisionTreeTrainer.cc:398-447).  Example counts
here are tiny (thousands), so the host runs it instantly in f64; the
formulation scales to device execution unchanged.

Semantics preserved exactly:
  * example = (properties, nObs, sum[D], sumsq[D]); pooled diagonal
    Gaussian -LL = 0.5 n (D + D log 2pi + sum log sigma^2) with variance
    clipping (Speech/DecisionTreeTrainer.cc:130-174);
  * gain = father - (left + right), must be >= min-gain, both sides
    >= min-obs, strict mode additionally rejects empty/zero-gain splits
    (Cart/DecisionTreeTrainer.cc:398-447 splitNode);
  * greedy global best-first: a priority queue of (node, best split)
    ordered by gain; committing a split removes the used question from
    the list handed to the children (commitSplit :529-545) and respects
    the leaf budget  nLeaf + open nodes + queued splits < max-leaves;
  * step actions: "split" (both children reopened), "partition" (only
    the NO-child reopened, YES-child kept for the next step), "cluster"
    (YES-child becomes a final leaf) (:579-635);
  * leaves are numbered in commit order (nCluster_), internal nodes
    carry the used-question index remapped to the used-question list
    (finish :665-700) — the written XML round-trips through
    sprint/cart.DecisionTree.read.

Port: a copy of speechrecognition_tpu/sprint/cart_train.py (host code).
"""

from __future__ import annotations

import heapq
import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cart import DecisionTree, Question, TreeNode

LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class ExampleSet:
    """Dense example table: one row per distinct property tuple
    (Cart::Example with nObs + 2xD sum/sum-of-squares values)."""

    properties: List[Dict[str, str]]      # [E]
    counts: np.ndarray                    # f64 [E]
    sums: np.ndarray                      # f64 [E, D]
    sqsums: np.ndarray                    # f64 [E, D]

    @property
    def num_examples(self) -> int:
        return len(self.properties)

    @property
    def dim(self) -> int:
        return self.sums.shape[1]

    @staticmethod
    def accumulate(features: np.ndarray, labels: np.ndarray,
                   properties: List[Dict[str, str]]) -> "ExampleSet":
        """Speech::FeatureAccumulator: per-label first/second-moment
        sufficient statistics from aligned frames. labels[n] indexes
        properties; vectorized scatter-add over the corpus."""
        E = len(properties)
        N, D = features.shape
        x = np.asarray(features, np.float64)
        lab = np.asarray(labels, np.int64)
        counts = np.bincount(lab, minlength=E).astype(np.float64)
        sums = np.zeros((E, D))
        sqsums = np.zeros((E, D))
        np.add.at(sums, lab, x)
        np.add.at(sqsums, lab, x * x)
        return ExampleSet(list(properties), counts, sums, sqsums)


def _pooled_neg_ll(n: np.ndarray, s: np.ndarray, s2: np.ndarray,
                   var_floor: float) -> np.ndarray:
    """-LL of one diagonal Gaussian fit to pooled stats, batched over the
    leading axes of n [.] / s, s2 [., D]
    (Speech/DecisionTreeTrainer.cc:135-174)."""
    n = np.asarray(n, np.float64)
    D = s.shape[-1]
    safe_n = np.where(n > 0, n, 1.0)
    mu = s / safe_n[..., None]
    var = s2 / safe_n[..., None] - mu * mu
    var = np.maximum(var, var_floor)
    ll = 0.5 * n * (D + D * LOG_2PI + np.log(var).sum(axis=-1))
    return np.where(n > 0, ll, 0.0)


@dataclass
class Step:
    """One training-plan step (Cart::DecisionTreeTrainer::TrainingPlan::
    Step, Parser.cc:961)."""

    name: str
    action: str                   # split | partition | cluster
    questions: List[Question]
    min_obs: float = 0.0
    min_gain: float = 0.0
    n_random: int = 1             # N-best randomization (nRandomQuestion)


@dataclass
class TrainingPlan:
    steps: List[Step]
    max_leaves: int = 1 << 31
    variance_floor: float = 1e-10  # variance-clipping parameter

    @staticmethod
    def read_xml(path: str) -> "TrainingPlan":
        """Parse the <decision-tree-training> plan XML (Cart/Parser.cc)."""
        root = ET.parse(path).getroot()
        max_leaves = int(root.findtext("max-leaves", str(1 << 31)))
        steps = []
        for s in root.iter("step"):
            qs = []
            for q in s.iter("question"):
                key = (q.findtext("key") or "").strip()
                single = q.findtext("value")
                multi = q.findtext("values")
                if single is not None:
                    vals = frozenset([single.strip()])
                elif multi is not None:
                    vals = frozenset(multi.split())
                else:
                    vals = frozenset()
                qs.append(Question(key=key, values=vals,
                                   description=q.get("description", "")))
            rand = s.find("randomize")
            steps.append(Step(
                name=s.get("name", ""), action=s.get("action", "split"),
                questions=qs,
                min_obs=float(s.findtext("min-obs", "0")),
                min_gain=float(s.findtext("min-gain", "0")),
                n_random=int(rand.get("nQuestion")) if rand is not None else 1))
        return TrainingPlan(steps=steps, max_leaves=max_leaves)


@dataclass
class _TrainNode:
    members: np.ndarray            # bool [E]
    score: float                   # -LL of the node's pooled Gaussian
    n_obs: float
    depth: int
    order: int
    question_ids: List[int]        # remaining usable question indices
    question: int = -1             # global question id used to split
    left: Optional["_TrainNode"] = None
    right: Optional["_TrainNode"] = None


@dataclass
class SplitInfo:
    depth: int
    gain: float
    question: Question
    father_score: float
    left_score: float
    right_score: float
    n_left: float
    n_right: float


class CartTrainer:
    """Greedy best-first CART training (Cart::Training::start)."""

    def __init__(self, plan: TrainingPlan, examples: ExampleSet,
                 seed: Optional[int] = None):
        self.plan = plan
        self.ex = examples
        self.rng = np.random.default_rng(seed)
        self.splits: List[SplitInfo] = []
        # global question table across steps (questionRefs_)
        self.questions: List[Question] = []
        self._answers: List[np.ndarray] = []   # bool [E] per question

    # -- question answers ----------------------------------------------------

    def _add_questions(self, qs: Sequence[Question]) -> List[int]:
        ids = []
        for q in qs:
            ids.append(len(self.questions))
            self.questions.append(q)
            ans = np.fromiter(
                (p.get(q.key) in q.values for p in self.ex.properties),
                bool, self.ex.num_examples)
            self._answers.append(ans)
        return ids

    # -- split search ----------------------------------------------------------

    def _best_split(self, node: _TrainNode, step: Step) -> Optional[tuple]:
        """Best (or randomized N-best) split of a node over its remaining
        questions — all questions scored in one vectorized pass."""
        if node.n_obs < 2 * step.min_obs or not node.question_ids:
            return None
        qids = np.asarray(node.question_ids)
        ans = np.stack([self._answers[q] for q in qids])        # [Q, E]
        member = node.members
        left_mask = ans & member                                 # [Q, E]
        # batched sufficient statistics: matmul-shaped reductions
        lw = left_mask.astype(np.float64)
        n_left = lw @ self.ex.counts
        s_left = lw @ (self.ex.sums * 1.0)
        s2_left = lw @ self.ex.sqsums
        n_tot = float(self.ex.counts[member].sum())
        s_tot = self.ex.sums[member].sum(axis=0)
        s2_tot = self.ex.sqsums[member].sum(axis=0)
        n_right = n_tot - n_left
        s_right = s_tot[None] - s_left
        s2_right = s2_tot[None] - s2_left

        vf = self.plan.variance_floor
        ll_left = _pooled_neg_ll(n_left, s_left, s2_left, vf)
        ll_right = _pooled_neg_ll(n_right, s_right, s2_right, vf)
        gain = node.score - (ll_left + ll_right)

        n_left_ex = left_mask.sum(axis=1)
        n_right_ex = member.sum() - n_left_ex
        valid = ((n_left >= step.min_obs) & (n_right >= step.min_obs)
                 & (n_left > 0) & (n_right > 0)                  # strict
                 & (n_left_ex > 0) & (n_right_ex > 0)
                 & (gain >= step.min_gain) & (gain > 0.0))
        if not valid.any():
            return None
        order = np.argsort(-gain)
        order = order[valid[order]]
        if step.n_random > 1:
            pick = int(self.rng.integers(0, min(step.n_random, len(order))))
        else:
            pick = 0
        qi = int(order[pick])
        return (int(qids[qi]), float(gain[qi]), float(ll_left[qi]),
                float(ll_right[qi]), float(n_left[qi]), float(n_right[qi]))

    # -- training loop ---------------------------------------------------------

    def train(self) -> Tuple[DecisionTree, List[_TrainNode]]:
        ex = self.ex
        member0 = np.ones(ex.num_examples, bool)
        n0 = float(ex.counts.sum())
        score0 = float(_pooled_neg_ll(
            np.asarray(n0), ex.sums.sum(axis=0), ex.sqsums.sum(axis=0),
            self.plan.variance_floor))
        order = [0]

        def mk(members, score, n_obs, depth, qids):
            node = _TrainNode(members, score, n_obs, depth, order[0], qids)
            order[0] += 1
            return node

        root = mk(member0, score0, n0, 0, [])
        open_nodes: List[_TrainNode] = [root]
        n_leaf = 0

        for step in self.plan.steps:
            if n_leaf + len(open_nodes) >= self.plan.max_leaves:
                break
            qids = self._add_questions(step.questions)
            heap: List[tuple] = []
            ticket = 0

            def suggest(node: _TrainNode):
                # children keep the father's list minus the used question
                # (commitSplit's swap-and-pop); only nodes pending at step
                # START get the step's fresh question list.
                nonlocal ticket
                best = self._best_split(node, step)
                if best is None:
                    open_nodes.append(node)
                else:
                    heapq.heappush(heap, (-best[1], ticket, node, best))
                    ticket += 1

            pending, open_nodes = open_nodes, []
            for node in pending:
                node.question_ids = list(qids)
                best = self._best_split(node, step)
                if best is None:
                    open_nodes.append(node)
                else:
                    heapq.heappush(heap, (-best[1], ticket, node, best))
                    ticket += 1

            while heap and (n_leaf + len(open_nodes) + len(heap)
                            < self.plan.max_leaves):
                _, _, node, (q, gain, ll_l, ll_r, n_l, n_r) = heapq.heappop(heap)
                ans = self._answers[q]
                child_qids = [x for x in node.question_ids if x != q]
                left = mk(node.members & ans, ll_l, n_l, node.depth + 1,
                          list(child_qids))
                right = mk(node.members & ~ans, ll_r, n_r, node.depth + 1,
                           list(child_qids))
                node.question = q
                node.left, node.right = left, right
                self.splits.append(SplitInfo(
                    depth=node.depth, gain=gain, question=self.questions[q],
                    father_score=node.score, left_score=ll_l,
                    right_score=ll_r, n_left=n_l, n_right=n_r))
                if step.action == "split":
                    suggest(left)
                    suggest(right)
                elif step.action == "partition":
                    open_nodes.append(left)     # reopened next step
                    suggest(right)
                elif step.action == "cluster":
                    n_leaf += 1                  # left child is final
                    suggest(right)
                else:
                    raise ValueError(f"unknown action {step.action!r}")
            # unexpanded queued splits roll back to open nodes
            while heap:
                _, _, node, _ = heapq.heappop(heap)
                open_nodes.append(node)

        return self._finish(root), self._leaves(root)

    @staticmethod
    def _leaves(root: _TrainNode) -> List[_TrainNode]:
        out, stack = [], [root]
        while stack:
            n = stack.pop()
            if n.left is None:
                out.append(n)
            else:
                stack.extend([n.right, n.left])
        return out

    def _finish(self, root: _TrainNode) -> DecisionTree:
        """Number leaves in commit order, remap internal node ids to the
        used-question list (Cart::Training::finish)."""
        used: List[int] = []
        qmap: Dict[int, int] = {}

        def walk(n: _TrainNode) -> TreeNode:
            if n.left is None:
                leaf_id = walk.n_cluster
                walk.n_cluster += 1
                return TreeNode(id=leaf_id)
            if n.question not in qmap:
                qmap[n.question] = len(used)
                used.append(n.question)
            return TreeNode(id=qmap[n.question],
                            left=walk(n.left), right=walk(n.right))

        walk.n_cluster = 0
        new_root = walk(root)
        questions = [self.questions[q] for q in used]
        value_maps: Dict[str, Dict[str, int]] = {}
        for p in self.ex.properties:
            for k, v in p.items():
                value_maps.setdefault(k, {})
                if v not in value_maps[k]:
                    value_maps[k][v] = len(value_maps[k])
        return DecisionTree(questions=questions, root=new_root,
                            value_maps=value_maps)


def write_tree_xml(tree: DecisionTree, path: str,
                   info: Optional[Dict[int, dict]] = None) -> None:
    """Serialize in the reference's decision-tree XML format
    (example-setup/data/cart.1.tree layout) so sprint/cart.DecisionTree.read
    round-trips."""
    lines = ['<?xml version="1.0" encoding="ISO-8859-1"?>', "<decision-tree>"]
    lines.append("    <properties-definition>")
    for key, vm in tree.value_maps.items():
        lines.append(f"        <key>{key}</key>")
        lines.append("        <value-map>")
        for val, vid in sorted(vm.items(), key=lambda kv: kv[1]):
            lines.append(f'            <value id="{vid}">{val}</value>')
        lines.append("        </value-map>")
    lines.append("    </properties-definition>")
    lines.append("    <questions>")
    for q in tree.questions:
        desc = f' description="{q.description}"' if q.description else ""
        lines.append(f"        <question{desc}>")
        lines.append(f"            <key>{q.key}</key>")
        if len(q.values) == 1:
            lines.append(f"            <value>{next(iter(q.values))}</value>")
        else:
            lines.append("            <values>"
                         + " ".join(sorted(q.values)) + "</values>")
        lines.append("        </question>")
    lines.append("    </questions>")
    lines.append("    <binary-tree>")

    def emit(node: TreeNode, indent: int):
        pad = " " * indent
        lines.append(f'{pad}<node id="{node.id}">')
        if node.left is not None:
            emit(node.left, indent + 4)
            emit(node.right, indent + 4)
        lines.append(f"{pad}</node>")

    emit(tree.root, 8)
    lines.append("    </binary-tree>")
    lines.append("</decision-tree>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
