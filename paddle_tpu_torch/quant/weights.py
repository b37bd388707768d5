"""The weight-quantization hooks every ``lm_*`` entry point calls
(``paddle_tpu/quant/weights.py``).  On a float tree they are identity;
serving an int8 tree is a later ROADMAP item, so one raises."""

# leaf formats of the JAX package: quant/weights' {"q", "s"} and
# export.quantize_params' {"__int8__", "__scale__"}
_LEAF_KEYS = (("q", "s"), ("__int8__", "__scale__"))


def _leaf_keys(leaf):
    if isinstance(leaf, dict):
        for qk, sk in _LEAF_KEYS:
            if qk in leaf and sk in leaf \
                    and str(getattr(leaf[qk], "dtype", "")).endswith("int8"):
                return qk, sk
    return None


def is_quantized_leaf(leaf):
    """True for a quantized-weight leaf (``{"q", "s"}`` or
    ``{"__int8__", "__scale__"}`` with int8 payload)."""
    return _leaf_keys(leaf) is not None


def is_quantized_tree(tree):
    """True when any leaf of the (nested dict/list) tree is quantized."""
    if is_quantized_leaf(tree):
        return True
    if isinstance(tree, dict):
        return any(is_quantized_tree(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(is_quantized_tree(v) for v in tree)
    return False


def maybe_dequant(params):
    """Pass a float tree through untouched; an int8 tree raises."""
    if is_quantized_tree(params):
        raise NotImplementedError(
            "int8 weight trees are not yet ported to paddle_tpu_torch "
            "(ROADMAP: int8 weights and KV)")
    return params


def weight_shape(leaf):
    """Logical (pre-quantization) shape of a weight leaf."""
    keys = _leaf_keys(leaf)
    if keys is not None:
        return tuple(leaf[keys[0]].shape)
    return tuple(leaf.shape)
