"""The benchmark's plain reference of the encoder's decisions: frozen
copies of the CTU step (K1's function) and the subpel refine (K2's), and
of the operations they use, in plain torch.  It imports nothing of the
program."""
