"""The port's IR: the canonical-JSON program desc (``desc``), its type
vocabulary (``types``) and the op registry (``registry``)."""
