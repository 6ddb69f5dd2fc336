"""Behavior trees, batched (the port's ``fyrox_tpu.utils.behavior``).

Equivalent of fyrox-impl/src/utils/behavior/ (517 LoC: Sequence/Selector
composites + leaf nodes returning Success/Failure/Running). The tree
topology is static (host-built); evaluation is a pure function over
per-world leaf statuses, so thousands of agents tick their trees in one
vectorized pass.

Leaves are evaluated by the caller (game logic) into a [W, n_leaves] status
array; `tick` folds composites bottom-up. `Running` propagates like the
reference: a Sequence returns the first non-Success child's status, a
Selector returns the first non-Failure child's status.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

__all__ = ["Status", "BehaviorTree", "BehaviorTreeBuilder"]

SEQUENCE, SELECTOR, INVERTER, LEAF = 0, 1, 2, 3


class Status:
    SUCCESS, FAILURE, RUNNING = 0, 1, 2


@dataclass
class BehaviorTree:
    kind: np.ndarray        # [N]
    parent: np.ndarray      # [N]
    children: List[List[int]]
    leaf_index: np.ndarray  # [N] index into the leaf status array (-1)
    root: int = 0
    # post-order evaluation schedule (children before parents)
    order: np.ndarray = None

    @property
    def num_leaves(self):
        return int((self.leaf_index >= 0).sum())

    def tick(self, leaf_status):
        """leaf_status [W, n_leaves] int → root status [W] int32, folded in
        post-order (a static Python loop: trees are small)."""
        status = [None] * len(self.kind)
        for ni in self.order:
            k = int(self.kind[ni])
            if k == LEAF:
                status[ni] = leaf_status[:, int(self.leaf_index[ni])].to(
                    torch.int32)
            elif k == INVERTER:
                c = status[self.children[ni][0]]
                status[ni] = torch.where(
                    c == Status.SUCCESS, Status.FAILURE,
                    torch.where(c == Status.FAILURE, Status.SUCCESS, c)
                ).to(torch.int32)
            else:
                # sequence: first non-success wins; selector: first
                # non-failure
                passthrough = Status.SUCCESS if k == SEQUENCE \
                    else Status.FAILURE
                acc = torch.full((leaf_status.shape[0],), passthrough,
                                 dtype=torch.int32, device=leaf_status.device)
                done = torch.zeros_like(acc, dtype=torch.bool)
                for ci in self.children[ni]:
                    c = status[ci]
                    takes = (~done) & (c != passthrough)
                    acc = torch.where(takes, c, acc)
                    done = done | takes
                status[ni] = acc
        return status[self.root]


class BehaviorTreeBuilder:
    def __init__(self):
        self._kind: List[int] = []
        self._parent: List[int] = []
        self._children: List[List[int]] = []
        self._leaf: List[int] = []
        self._n_leaves = 0

    def _add(self, kind, parent):
        self._kind.append(kind)
        self._parent.append(parent)
        self._children.append([])
        self._leaf.append(-1)
        idx = len(self._kind) - 1
        if parent >= 0:
            self._children[parent].append(idx)
        return idx

    def sequence(self, parent=-1) -> int:
        return self._add(SEQUENCE, parent)

    def selector(self, parent=-1) -> int:
        return self._add(SELECTOR, parent)

    def inverter(self, parent=-1) -> int:
        return self._add(INVERTER, parent)

    def leaf(self, parent) -> int:
        idx = self._add(LEAF, parent)
        self._leaf[idx] = self._n_leaves
        self._n_leaves += 1
        return idx

    def build(self, root=0) -> BehaviorTree:
        # post-order schedule
        order = []
        def visit(i):
            for c in self._children[i]:
                visit(c)
            order.append(i)
        visit(root)
        return BehaviorTree(kind=np.asarray(self._kind, np.int32),
                            parent=np.asarray(self._parent, np.int32),
                            children=self._children,
                            leaf_index=np.asarray(self._leaf, np.int32),
                            root=root, order=np.asarray(order, np.int32))
