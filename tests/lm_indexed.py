"""``LM`` with each layer's parameters taken by indexing its stacks,
``x[idx]`` on every leaf (``LM._layer_params``), the way ``prefill`` and
``decode_step`` take them, in place of ``LM.forward``'s one ``unbind`` per
leaf: the same loss and gradients, but each index's backward
(``select_backward``) zero-fills a gradient of the whole stack, and
autograd adds one of them per layer.  The tests of ``LM.forward``'s
gradients hold it to this path.
"""
from repro_torch.models.transformer.model import LM


class IndexedLM(LM):
    def _unbound_layers(self, params):
        for group, key, kind, idx in self._layers():
            yield group, key, kind, idx, self._layer_params(params, group,
                                                            key, idx)
