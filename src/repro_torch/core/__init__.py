"""Core runtime of the port: quantization, bricks, backends, the plan,
the TABM ring, slot classes, battery policy and admission budgets."""
