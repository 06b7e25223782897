"""Evaluation tasks."""
