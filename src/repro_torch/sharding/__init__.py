"""How every tensor of the port is partitioned over the rank mesh."""
