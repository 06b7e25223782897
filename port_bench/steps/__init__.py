"""How each task's timed step is called, which per-pair outputs it
returns, and how they are compared (one module a task, named by the
traffic file's "task")."""
