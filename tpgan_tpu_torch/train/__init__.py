"""Model construction, the synthesis (serving) function, the fused
WGAN-GP train step and its optimizer."""
