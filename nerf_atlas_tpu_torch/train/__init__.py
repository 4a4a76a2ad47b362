"""Eval driver and checkpoints (training arrives with ROADMAP Queue 1 #5)."""
