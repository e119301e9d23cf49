"""Pipeline layer partitioning (counterpart of
paddle_tpu/distributed/meta_parallel/pp_layers.py; reference:
fleet/meta_parallel/parallel_layers/pp_layers.py:76 PipelineLayer,
SegmentLayers:23, SharedLayerDesc:62).

A PipelineLayer describes the model as a flat list of LayerDescs and
assigns contiguous segments of it to the stages of the 'pp' axis. The
JAX package builds every layer in its one process and picks a stage's
segment inside the schedule; here each rank is one stage, and, as in
Paddle, a PipelineLayer builds only its own stage's layers. A
SharedLayerDesc's layer is built on every stage whose segment uses it:
its weights are broadcast from the first such stage at construction, and
the schedule (distributed/pipeline.py) sums its grads over those stages
(`tied_params`). The schedule runs the stage through `forward`.
"""
import torch
import torch.distributed as dist
from torch import nn

__all__ = ['LayerDesc', 'SharedLayerDesc', 'PipelineLayer', 'SegmentLayers']


class LayerDesc:
    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """Tied weights across stages (e.g. embedding / unembedding)."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr='weight', *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    def __init__(self, layers_desc, num_parts, method='uniform'):
        self.layers_desc = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self):
        n = len(self.layers_desc)
        if self.method == 'uniform':
            return self.uniform(n, self.num_parts)
        if self.method.startswith('layer:'):
            # segment at layers whose class name matches
            name = self.method.split(':', 1)[1]
            marks = [i for i, d in enumerate(self.layers_desc)
                     if getattr(d, 'layer_cls', type(None)).__name__ == name]
            # distribute matched blocks evenly over parts
            per = max(1, len(marks) // self.num_parts)
            bounds = [0]
            for p in range(1, self.num_parts):
                idx = min(p * per, len(marks) - 1)
                bounds.append(marks[idx])
            bounds.append(n)
            return bounds
        raise ValueError(self.method)

    @staticmethod
    def uniform(num_items, num_parts):
        result = [0] * (num_parts + 1)
        part_size = num_items // num_parts
        extra = num_items % num_parts
        for i in range(1, num_parts + 1):
            result[i] = result[i - 1] + part_size + (1 if i <= extra else 0)
        return result


class PipelineLayer(nn.Module):
    """Declarative pipeline container. num_stages defaults to the hybrid
    group's pp degree (1 without one); the stage is the hybrid group's
    stage id. On one stage it runs like Sequential. The built layers are
    registered under their index in the description list (`layer(i)`
    gives the one of index i, None when another stage holds it)."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method='uniform', recompute_interval=0,
                 **kwargs):
        super().__init__()
        from ..topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        if num_stages is None:
            num_stages = hcg.get_pipe_parallel_world_size() if hcg else 1
        self._layers_desc = list(layers)
        self._num_stages = int(num_stages)
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self.segment_parts = SegmentLayers(
            self._layers_desc, self._num_stages, seg_method).do_segment()
        self._stage = 0
        self._mesh = None
        if self._num_stages > 1:
            if hcg is None or \
                    hcg.get_pipe_parallel_world_size() != self._num_stages:
                raise ValueError(
                    'PipelineLayer over %d stages needs a hybrid group of '
                    'pp degree %d (fleet.init)' % (self._num_stages,
                                                   self._num_stages))
            self._stage = hcg.get_stage_id()
            self._mesh = hcg.mesh
        lo, hi = self.segment_parts[self._stage:self._stage + 2]

        self._shared = nn.ModuleDict()
        self._built = nn.ModuleDict()
        self._index = {}
        self.run_function = []
        for i, d in enumerate(self._layers_desc[lo:hi], start=lo):
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared:
                    self._shared[d.layer_name] = d.build_layer()
                layer = self._shared[d.layer_name]
                fwd = d.forward_func
                self.run_function.append(
                    layer if fwd is None else
                    (lambda l, f: (lambda x: f(l, x)))(layer, fwd))
            elif isinstance(d, LayerDesc):
                layer = d.build_layer()
                self._built[str(i)] = layer
                self.run_function.append(layer)
            elif isinstance(d, nn.Module):
                layer = d
                self._built[str(i)] = layer
                self.run_function.append(layer)
            else:  # a plain callable
                layer = None
                self.run_function.append(d)
            self._index[i] = layer
        self._pp_tied = self._tie_shared()

    def _tie_shared(self):
        """[(layer, attribute, Group)] of the shared layers' weights used
        on more than one stage: each weight broadcast from the first stage
        using it. Every rank makes every key's group, in description
        order."""
        if self._num_stages == 1:
            return []
        from ..topology import pp_line, stage_group
        stages = {}
        for s in range(self._num_stages):
            lo, hi = self.segment_parts[s:s + 2]
            for d in self._layers_desc[lo:hi]:
                if isinstance(d, SharedLayerDesc):
                    stages.setdefault(d.layer_name, (d, []))[1].append(s)
        line = pp_line(self._mesh)
        tied = []
        for key, (desc, used) in stages.items():
            group = stage_group(self._mesh, used)
            if group is None or key not in self._shared:
                continue
            layer = self._shared[key]
            with torch.no_grad():
                dist.broadcast(getattr(layer, desc.shared_weight_attr).data,
                               src=line.ranks[min(used)], group=group.pg)
            tied.append((layer, desc.shared_weight_attr, group))
        return tied

    @property
    def stage_segments(self):
        return self.segment_parts

    def tied_params(self):
        """[(parameter, Group)]: the weights whose grads the schedule sums
        over the stages that share them."""
        return [(getattr(m, a), g) for m, a, g in self._pp_tied]

    def layer(self, index):
        """The built layer of description `index` (None when another
        stage holds it or the description is a plain callable)."""
        return self._index.get(index)

    def forward(self, x):
        """This stage's segment (every layer on one stage)."""
        for f in self.run_function:
            x = f(x)
        return x
