"""One module a kind of cell (``train``, ``decode``), found by the kind's name."""
