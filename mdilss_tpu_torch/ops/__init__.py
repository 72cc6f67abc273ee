"""Ops of the port: eval-mode BN helpers and the hand-written nb1d kernel."""
