"""The emulated sPIN switch data plane: framing, handlers, the tree loop."""
