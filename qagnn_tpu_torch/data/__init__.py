"""Data layer: statement tokenization, subgraph loading, batch iteration."""
