"""Tree-based index for TDM-style retrieval training (counterpart of
paddle_tpu/distributed/index_dataset.py, the same code: numpy only).

Parity: paddle/fluid/distributed/index_dataset/ (index_wrapper.h TreeIndex
+ IndexWrapper, index_sampler.h LayerWiseSampler/BeamSearchSampler,
python/paddle/distributed/fleet/dataset/index_dataset.py). The protobuf
node storage collapses to numpy arrays; codes use the max-heap layout
(children of code c under branch b are b*c+1 .. b*c+b), same as TDM.
"""
import numpy as np

__all__ = ['TreeIndex', 'IndexWrapper', 'LayerWiseSampler',
           'BeamSearchSampler']


class TreeIndex:
    """A complete b-ary tree over item ids.

    Leaves hold item ids; internal nodes are virtual categories. Node
    `code` is the heap position (root=0); `id` of a leaf is the item id,
    internal nodes get synthetic ids above max_item_id.
    """

    def __init__(self, name='tree', branch=2):
        self.name = name
        self.branch = branch
        self._code_to_id = {}
        self._id_to_code = {}
        self._height = 0

    # -- construction --------------------------------------------------------
    @classmethod
    def from_items(cls, item_ids, name='tree', branch=2):
        """Build a balanced tree with the given leaf items (offline
        clustering in the reference; here items are placed in given order,
        which callers can pre-sort by embedding similarity)."""
        t = cls(name=name, branch=branch)
        n = len(item_ids)
        height = 1
        cap = 1
        while cap < n:
            cap *= branch
            height += 1
        t._height = height
        first_leaf = (branch ** (height - 1) - 1) // (branch - 1) \
            if branch > 1 else height - 1
        next_internal = max(item_ids) + 1 if len(item_ids) else 0
        for i, item in enumerate(item_ids):
            code = first_leaf + i
            t._code_to_id[code] = int(item)
            t._id_to_code[int(item)] = code
        # materialize ancestors of used leaves
        used = sorted(t._code_to_id)
        seen = set(used)
        for code in used:
            c = code
            while c > 0:
                c = (c - 1) // branch
                if c in seen:
                    break
                seen.add(c)
                t._code_to_id[c] = next_internal
                t._id_to_code[next_internal] = c
                next_internal += 1
        return t

    def save(self, path):
        arr = np.asarray(sorted(self._code_to_id.items()), np.int64)
        np.savez(path, codes_ids=arr, branch=self.branch,
                 height=self._height)

    @classmethod
    def load(cls, path, name='tree'):
        data = np.load(path if path.endswith('.npz') else path + '.npz')
        t = cls(name=name, branch=int(data['branch']))
        t._height = int(data['height'])
        for code, nid in data['codes_ids']:
            t._code_to_id[int(code)] = int(nid)
            t._id_to_code[int(nid)] = int(code)
        return t

    # -- queries (index_wrapper.h surface) -----------------------------------
    def total_node_nums(self):
        return len(self._code_to_id)

    def height(self):
        return self._height

    def branch_size(self):
        return self.branch

    def _level_of(self, code):
        level, c = 0, code
        while c > 0:
            c = (c - 1) // self.branch
            level += 1
        return level

    def get_all_leafs(self):
        first_leaf = (self.branch ** (self._height - 1) - 1) // \
            (self.branch - 1) if self.branch > 1 else self._height - 1
        return [nid for code, nid in sorted(self._code_to_id.items())
                if code >= first_leaf]

    def get_nodes(self, codes):
        return [self._code_to_id.get(int(c), -1) for c in codes]

    def get_layer_codes(self, level):
        return [c for c in sorted(self._code_to_id)
                if self._level_of(c) == level]

    def get_travel_codes(self, item_id):
        """Leaf→root path codes for an item (reference get_travel_codes)."""
        code = self._id_to_code[int(item_id)]
        out = [code]
        while code > 0:
            code = (code - 1) // self.branch
            out.append(code)
        return out

    def get_travel_path(self, child, ancestor):
        out = []
        while child > ancestor:
            out.append(child)
            child = (child - 1) // self.branch
        return out

    def get_ancestor_codes(self, item_ids, level):
        out = []
        for i in item_ids:
            code = self._id_to_code[int(i)]
            while self._level_of(code) > level:
                code = (code - 1) // self.branch
            out.append(code)
        return out

    def get_children_codes(self, code, level=None):
        lo = code * self.branch + 1
        kids = [lo + i for i in range(self.branch)]
        return [k for k in kids if k in self._code_to_id]

    def get_pi_relation(self, item_ids, level):
        """item id -> its ancestor code at `level`."""
        return {int(i): a for i, a in
                zip(item_ids, self.get_ancestor_codes(item_ids, level))}


class IndexWrapper:
    """Named registry of tree indexes (index_wrapper.h IndexWrapper)."""

    def __init__(self):
        self._trees = {}

    def insert_tree_index(self, name, tree_path):
        self._trees[name] = TreeIndex.load(tree_path, name=name)

    def add_tree_index(self, name, tree):
        self._trees[name] = tree

    def get_tree_index(self, name):
        if name not in self._trees:
            raise KeyError('tree index %r not registered' % name)
        return self._trees[name]

    def clear_tree(self):
        self._trees.clear()


class LayerWiseSampler:
    """TDM layer-wise sampling (index_sampler.h LayerWiseSampler): for each
    (user, target item) pair emit per-layer (positive ancestor, sampled
    negatives-in-layer) training rows, root layer excluded."""

    def __init__(self, tree, layer_sample_counts=None, start_sample_layer=1,
                 seed=0):
        self.tree = tree
        self.start = start_sample_layer
        self.counts = layer_sample_counts
        self.rng = np.random.RandomState(seed)
        # per-level code lists precomputed once: sample() runs per batch
        # and must not rescan the whole tree per (item, level)
        self._layers = [tree.get_layer_codes(lvl)
                        for lvl in range(tree.height())]

    def sample(self, user_inputs, target_ids, with_hierarchy=False):
        rows = []
        height = self.tree.height()
        for user, item in zip(user_inputs, target_ids):
            codes = self.tree.get_travel_codes(item)
            # codes: leaf .. root; layer index = height-1 .. 0
            for code in codes[:-1]:
                level = self.tree._level_of(code)
                if level < self.start:
                    continue
                layer = self._layers[level]
                k = (self.counts[level - self.start]
                     if self.counts and level - self.start < len(self.counts)
                     else min(4, max(len(layer) - 1, 1)))
                negs = [c for c in layer if c != code]
                if negs:
                    sel = self.rng.choice(len(negs),
                                          size=min(k, len(negs)),
                                          replace=False)
                    neg_codes = [negs[int(s)] for s in sel]
                else:
                    neg_codes = []
                rows.append((list(user), self.tree._code_to_id[code], 1))
                for nc in neg_codes:
                    rows.append((list(user), self.tree._code_to_id[nc], 0))
        return rows


class BeamSearchSampler:
    """Beam retrieval over the tree with a user-supplied scorer
    (index_sampler.h BeamSearchSampler): at each level keep the best
    `beam_size` children by score(user, node_id)."""

    def __init__(self, tree, beam_size=2):
        self.tree = tree
        self.beam = beam_size

    def sample(self, user, score_fn):
        frontier = [0]
        height = self.tree.height()
        for level in range(height - 1):
            kids = []
            for code in frontier:
                kids += self.tree.get_children_codes(code)
            if not kids:
                break
            ids = self.tree.get_nodes(kids)
            scores = np.asarray([score_fn(user, nid) for nid in ids])
            top = np.argsort(-scores)[:self.beam]
            frontier = [kids[int(i)] for i in top]
        return self.tree.get_nodes(frontier)
