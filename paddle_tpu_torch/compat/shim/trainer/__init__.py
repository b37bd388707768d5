"""``paddle.trainer`` during a port parse (see ``compat/shim``)."""
