"""The gradient-reduction engine: arena, topology, collectives, transports."""
