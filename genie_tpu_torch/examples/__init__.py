"""Script twins of the repo's ``examples/`` (the reference's tutorial
notebooks), on the port: ``python -m genie_tpu_torch.examples.<name>``,
on the card unless given ``--device cpu``."""
