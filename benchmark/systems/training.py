"""The training route of the port under test: the multi-step of
``train/loop.py`` (``make_multi_train_step``, ``fused_ctx=True``: kernel
K3) over ``create_train_state``'s Adam with the configuration's cosine
learning rate, on a model built from the configuration's file with the
benchmark's weights, fed from synthetic windows on the card.

Set-up builds the one training state that the window then drives and
runs its first calls (1 step, then 2 steps, then one of the mix's length)
through the window's own call and feed, keeping what the check reads: the
first three steps' losses, the first step's gradients as Adam holds them
(its first moment over 1 - b1) and the parameters after the third step.
A call enqueues its steps and returns without waiting for the card; the
window ends when the card has finished them.
"""

from __future__ import annotations

import torch

from ..traffic import training as traffic_mod
from . import build


class TrainingSystem:
    def __init__(self, config: dict, params: dict, seed: int, device, spans):
        from raggesture_tpu_torch.train.loop import (
            OptimConfig,
            create_train_state,
            make_multi_train_step,
        )

        self.config, self.device, self.spans = config, device, spans
        route, opt = config["routes"]["training"], config["optimizer"]
        with spans("setup.model"):
            model = build.model(config, seed, device)
            self.state = create_train_state(model, OptimConfig(
                lr=opt["lr"], min_lr_ratio=opt["min_lr_ratio"],
                total_steps=opt["total_steps"], grad_clip=opt["grad_clip"],
                fused_ctx=route["fused_ctx"]))
            self.step = make_multi_train_step(
                model.cfg.diffusion_train.schedule(device),
                fused_ctx=route["fused_ctx"],
                bf16_compute=route["bf16_compute"])
        self.data = traffic_mod.dataset(config, params, seed, device)
        self.first = {"losses": []}

    def warm_up(self, traffic) -> None:
        """The state's first calls, the same call and feed as the window's:
        1 step (its gradients kept), 2 steps (the parameters after them
        kept), then one of the window's length."""
        den = self.state.model.denoiser
        opt = self.state.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        for j in range(len(traffic.warm)):
            logs = self.serve(traffic.warm_up_request(j))
            if j < 2:
                self.first["losses"] += logs["recon_loss"].tolist()
            if j == 0:
                self.first["grads"] = {
                    "denoiser." + n: (opt.state[p]["exp_avg"] / (1 - b1)
                                      ).detach().clone()
                    for n, p in den.named_parameters() if p in opt.state}
            if j == 1:
                self.first["params"] = {
                    "denoiser." + n: p.detach().clone()
                    for n, p in den.named_parameters()}

    def serve(self, req: dict) -> dict:
        with self.spans("inputs"):
            batch = traffic_mod.batch(self.data, req, self.device)
            draws = traffic_mod.draws(self.config, req, self.device)
        with self.spans("step"):
            return self.step(self.state, batch, None, **draws)

    def drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def failed(req: dict, out: dict) -> int:
        """Samples of the steps whose loss is not finite."""
        bad = ~torch.isfinite(out["recon_loss"].float().cpu())
        return int(bad.sum()) * req["rows"].shape[1]

    def work(self, traffic, reqs) -> dict:
        return {"kind": "training", "batch": traffic.batch,
                "steps": sum(r["steps"] for r in reqs)}

    def evidence(self) -> dict:
        return self.first

    def close(self) -> None:
        del self.state, self.step, self.data
