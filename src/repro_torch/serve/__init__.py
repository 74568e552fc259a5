"""Serving: paged KV pool and the slot_paged engine."""
