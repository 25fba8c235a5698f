"""Vanilla knowledge distillation (paper §IV-D: recover post-pruning
accuracy before transfer, VanillaKD [15])."""
from __future__ import annotations

import torch


def kd_loss(student_logits, teacher_logits, temperature: float = 4.0):
    """KL(teacher || student) at temperature T, scaled by T^2."""
    t = temperature
    sp = torch.log_softmax(student_logits.float() / t, dim=-1)
    tp = torch.softmax(teacher_logits.float() / t, dim=-1)
    return (t * t) * torch.mean(torch.sum(tp * (torch.log(tp + 1e-9) - sp),
                                          dim=-1))


def combined_kd_loss(student_logits, teacher_logits, labels,
                     alpha: float = 0.5, temperature: float = 4.0):
    """alpha * KD + (1-alpha) * CE."""
    s = student_logits.float()
    lse = torch.logsumexp(s, dim=-1)
    gold = torch.gather(s, -1, labels.long()[:, None])[:, 0]
    ce = torch.mean(lse - gold)
    return alpha * kd_loss(student_logits, teacher_logits, temperature) + \
        (1 - alpha) * ce
