"""The sampling route of the port under test: ``StagedGenerator.sample``
on a model built from the configuration's file, with the benchmark's
weights.

Set-up builds the model on the card with no weights, loads the weights the
benchmark made from the seed (a strict load: the port's parameter tree has
to be the configuration's), builds the generator with the route's options,
and makes the feature pools.  Serving a request gathers its features (a
copy from host memory for a host pool), makes its start noise and the
generator of the scale function's coins from the request's seed, calls
``sample`` and copies the decoded motion and the latents to the host, as
the serving tool does (``.float().cpu()``).
"""

from __future__ import annotations

import torch

from ..traffic import sampling as traffic_mod
from . import build

OUTPUT_KEYS = ("pred_upper", "pred_hands", "pred_facepose", "pred_lower",
               "pred_transl", "pred_exps", "pred_contact", "output_latents")


class SamplingSystem:
    def __init__(self, config: dict, params: dict, seed: int, device, spans):
        from raggesture_tpu_torch.models.architecture import StagedGenerator

        self.config, self.device = config, device
        self.spans = spans
        route = config["routes"]["sampling"]
        with spans("setup.model"):
            self.model = build.model(config, seed, device)
            arch = self.model.cfg
            graphs = route["graphs"] and device.type == "cuda"
            self.gen = StagedGenerator(
                self.model, arch.diffusion_test.schedule(),
                fused=route["fused"], layer_kernel=route["layer_kernel"],
                graphs=graphs)
        word, audio = traffic_mod.feature_pools(config, params, seed, device)
        if params["features_on"] == "host":
            word, audio = word.cpu(), audio.cpu()
        self.word, self.audio = word, audio
        self.mask = torch.ones(int(params["batch"]),
                               config["denoiser"]["max_seq_len"],
                               device=device)

    def warm_up(self, traffic) -> None:
        """Two requests of the window's one shape: the first builds the
        kernels and captures the pipeline's graph, the second replays it."""
        for j in range(2):
            self.serve(traffic.warm_up_request(j))

    def batch(self, req: dict) -> dict:
        if self.word.device.type == "cpu":
            word = self.word[torch.from_numpy(req["word"])]
            audio = self.audio[torch.from_numpy(req["audio"])]
        else:
            word = self.word[torch.as_tensor(req["word"], device=self.device)]
            audio = self.audio[torch.as_tensor(req["audio"],
                                               device=self.device)]
        return {"word": word, "audio": audio,
                "speaker_ids": torch.as_tensor(req["speaker"],
                                               device=self.device),
                "motion_mask": self.mask}

    def serve(self, req: dict) -> dict:
        spans = self.spans
        with spans("inputs"):
            batch = self.batch(req)
            noise = traffic_mod.start_noise(self.config, req, self.device)
            g = torch.Generator(device=self.device).manual_seed(
                req["noise_seed"])
        with spans("sample"):
            out = self.gen.sample(batch, generator=g, noise=noise)
        with spans("to_host"):
            return {k: out[k].float().cpu() for k in OUTPUT_KEYS}

    def drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def failed(req: dict, out: dict) -> int:
        """Clips of the request with a non-finite value anywhere."""
        bad = torch.zeros(len(req["speaker"]), dtype=torch.bool)
        for v in out.values():
            bad |= ~torch.isfinite(v.reshape(v.shape[0], -1)).all(dim=1)
        return int(bad.sum())

    def work(self, traffic, reqs) -> dict:
        """The traced requests' work: clips, and the batch of each."""
        return {"kind": "sampling",
                "batches": [traffic.units(r) for r in reqs]}

    def evidence(self):
        """What the check reads of the program besides the served
        answers: nothing here."""
        return None

    def close(self) -> None:
        del self.gen, self.model, self.word, self.audio
