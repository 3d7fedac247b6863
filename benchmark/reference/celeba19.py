"""Plain reference of the CelebA-19 MVAE (Wu & Goodman 2018; mhw32/
multimodal-vae-public, celeba19/model.py and celeba19/train.py): the
CelebA image expert, and each of the 18 binary attributes an expert of
its own.

    image encoder, decoder   CelebA's (celeba.py)
    attribute i encoder      Embedding(2, 512) of its 0/1 value, swish,
                             fc 512 -> 512, swish, fc -> 2L
    attribute i decoder      L -> 512 -> 512 -> 512 -> 1 logit, swish
                             between

Each attribute's loss is the BCE with logits of its one column. The
attribute decoders have no BatchNorm, so a term that leaves them at
weight 0 does not run them.
"""

from reference.celeba import Model as CelebaModel


class Model(CelebaModel):

    def expert_input(self, name, inputs):
        if name == "image":
            return inputs["image"]
        i = int(name.rsplit("_", 1)[1])
        return inputs["attrs"][:, i]

    def target(self, name, inputs):
        if name == "image":
            return inputs["image"]
        i = int(name.rsplit("_", 1)[1])
        return inputs["attrs"][:, i:i + 1]

    def target_loss(self, p, ops, z, inputs, targets):
        """"attrs" names the 18 attribute experts together."""
        names = {e["name"] for e in self.experts
                 if e["name"] in targets
                 or ("attrs" in targets and e["name"] != "image")}
        return super().target_loss(p, ops, z, inputs, names)
