"""The paper's experimental settings as synthetic analogs."""
