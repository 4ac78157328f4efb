"""One module per kind of configuration (``"kind"`` in its file): how a cell
of that kind is set up, measured and checked."""
