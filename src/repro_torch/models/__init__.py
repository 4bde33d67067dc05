"""The port's model families: the paper's late-interaction encoders
(``late_interaction.ColXEncoder``), the decoder-LM family
(``transformer.DecoderLM``) and the recsys family
(``recsys.nets.RecsysModel``)."""
