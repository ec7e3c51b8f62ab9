"""Fault accounting shared by the serving tiers (:mod:`.fault`)."""
