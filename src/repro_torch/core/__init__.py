"""Optimizers, wire codecs, sync policy and sync engine."""
