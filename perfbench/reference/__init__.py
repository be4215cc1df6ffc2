"""Plain references, one file a model family (``reference/<family>.py``),
each giving ``served_logits(params, model, serving, case)``. They import
nothing of the port."""
