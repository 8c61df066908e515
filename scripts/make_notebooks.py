"""Generate the jupyter/ workflow notebooks.

Role of the reference's Colab notebooks (reference
jupyter/val_jinpan_colab.ipynb, jupyter/val_online_colab.ipynb): a guided
end-to-end workflow (env setup → install → build databases → batch QA) and
an interactive-QA walkthrough.  The equivalents here drop the
Colab-specific machinery (Drive mount, pip installs, GPU/EasyOCR setup —
nothing to install here) and drive the in-repo demo set through the same
stages on the default JAX device.

Run ``python scripts/make_notebooks.py`` to (re)write the .ipynb files;
``--check`` additionally executes every code cell in a scratch copy of the
demo data to prove the notebooks run top to bottom.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def md(text: str) -> dict:
    return {"cell_type": "markdown", "metadata": {},
            "source": text.splitlines(keepends=True)}


def code(text: str) -> dict:
    return {"cell_type": "code", "metadata": {}, "execution_count": None,
            "outputs": [], "source": text.strip("\n").splitlines(keepends=True)}


def notebook(cells: list) -> dict:
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python", "version": "3.12"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


END_TO_END = [
    md("""# 金盘科技 RAG 问答 — 端到端工作流

on-device 版的端到端流程（对应 reference `jupyter/val_jinpan_colab.ipynb` 的
挂载 Drive → 安装依赖 → 建库 → 问答流程）。这里没有 Colab 机器：依赖已就绪，
计算在 JAX 默认设备（GPU / CPU）上执行，语料用仓库内置的 demo test set。

**流程**：解析报告 → 合并/分块 → 构建 on-device 索引 → 检索 → 批量问答 → 查看结果。

真实部署时把年报 PDF 放进 `<root>/pdf_reports/`（需要 docling），并配置
`DASHSCOPE_API_KEY` / `OPENAI_API_KEY` 等环境变量（见 `.env.example`）。
本 notebook 全程离线（`offline` 预设，StubProvider），可直接运行。"""),
    code("""
import os, json
from pathlib import Path

# 工作目录 = 仓库根（notebook 位于 jupyter/ 下时回退一级）
if not Path("main.py").exists() and Path("../main.py").exists():
    os.chdir("..")

ROOT = os.environ.get("RAG_ROOT", "data/test_set")  # demo 语料

from rag_challenge_2_tpu.utils.cache import enable_compile_cache
enable_compile_cache()  # 持久化 XLA 编译缓存，二次运行免编译

import jax
print("JAX devices:", jax.devices())
"""),
    md("""## 步骤 1 · 解析报告

`pdf_reports/` 里的报告 → 结构化 parsed-report JSON（docling 输出契约；demo
集是带分页符的纯文本，走 PlainText 解析器）。真实 PDF 需要安装 docling，并可用
`parallel=True` 多进程解析（reference `src/pdf_parsing.py:247`）。"""),
    code("""
from rag_challenge_2_tpu.pipeline import Pipeline, configs
import dataclasses

run_cfg = dataclasses.replace(configs["offline"])   # 离线预设（StubProvider）
pipe = Pipeline(Path(ROOT), run_cfg)
pipe.parse_pdf_reports()
sorted(p.name for p in pipe.paths.parsed_reports_path.glob("*.json"))
"""),
    md("""## 步骤 2 · 合并、分块并构建 on-device 索引

四个阶段一次完成（reference `src/pipeline.py:210`）：页面合并为 markdown →
导出 → 300 token / 50 overlap 分块 → 语料嵌入 + CSR 词项索引，产出单个
`CorpusIndex` npz（稠密矩阵 + BM25 CSR + 路由元数据，全部常驻设备）。

首次构建若无预训练 encoder 参数，会自动先跑一段 ICT 预训练
（`RAGTPU_AUTO_PRETRAIN=0` 关闭）。"""),
    code("""
os.environ.setdefault("RAGTPU_AUTO_PRETRAIN", "0")  # demo: 跳过自动预训练
pipe.process_parsed_reports()

from rag_challenge_2_tpu.index import load_index
idx, meta = load_index(pipe.paths.index_path)
print(f"chunks={idx.n_chunks} docs={idx.n_docs} dim={idx.dim} "
      f"pages={idx.n_pages} vocab_bits={idx.sparse.vocab_bits}")
"""),
    md("""## 步骤 3 · 一次检索（看看索引在做什么）

单个 jitted 图：查询嵌入 × 语料矩阵（matmul）→ 年份路由掩码 → fused
top-k → 页级聚合 + 命中/方法奖励（reference `src/retrieval.py:1639-1661` 的
语义，做成 segment ops）。"""),
    code("""
from rag_challenge_2_tpu.retrieval.engine import QueryEngine, SearchConfig

engine = QueryEngine(idx, meta)
question = "2024年营业收入是多少？"
q_emb = pipe.embedder([question])
cfg = SearchConfig(method="basic", top_n=5, top_k=10, use_bm25=True)
hits = engine.materialize(
    engine.search(q_emb, "金盘科技", question, cfg=cfg, query_texts=[question]), cfg)
for h in hits:
    print(f"[{h['distance']:.4f}] {h['source_sha1']} p{h['page']}: {h['text'][:60]}")
"""),
    md("""## 步骤 4 · 批量问答

`questions.json` 全量跑一遍：公司抽取 → 检索（可选 HyDE/Multi-Query 扩展、
LLM 重排序）→ 两阶段回答 → 引用页校验，增量写出 submission / debug 文件
（reference `src/questions_processing.py:1104`）。"""),
    code("""
result = pipe.process_questions()
print(json.dumps(result["statistics"], ensure_ascii=False, indent=2))
for a in result["questions"][:3]:
    print(a["question_text"], "→", a.get("value"))
"""),
    md("""## 步骤 5 · 查看产物 & 下一步

- submission / debug JSON 在 `<root>/answers_*.json`（不覆盖，自动编号）。
- 评分：`python main.py rank --submissions-dir … --answers …`（竞赛规则，
  reference `rank.py`）；LLM-as-judge 走 `eval.judge.JudgeHarness`。
- 交互式问答见 `jupyter/val_online.ipynb`；浏览器界面
  `python main.py serve`。
- GPU 端到端检查：`python chip_smoke.py`；基准测试：`python bench.py`。"""),
    code("""
out_files = sorted(pipe.paths.root_path.glob("answers_*.json"))
print("输出文件:", [f.name for f in out_files][-4:])
"""),
]

VAL_ONLINE = [
    md("""# 交互式问答（val_online）

对应 reference `jupyter/val_online_colab.ipynb` / `src/val_online.py`：
已建好索引后，直接用 Python API 提问、多轮追问、切换检索算法。先跑
`jupyter/end_to_end.ipynb`（或 `python main.py parse-pdfs &&
python main.py process-reports`）建库。"""),
    code("""
import os, dataclasses
from pathlib import Path

if not Path("main.py").exists() and Path("../main.py").exists():
    os.chdir("..")
ROOT = os.environ.get("RAG_ROOT", "data/test_set")

from rag_challenge_2_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

from rag_challenge_2_tpu.pipeline import Pipeline, configs

pipe = Pipeline(Path(ROOT), dataclasses.replace(configs["offline"]))
proc = pipe.build_processor()   # QuestionsProcessor：检索 + 回答 + 引用校验
print("ready:", proc.engine.index.n_chunks, "chunks")
"""),
    md("""## 单轮提问

问题不带公司名时自动补全默认公司（reference `src/val_online.py` 的
auto-prefix 行为在 webapp/REPL 层；这里显式传公司）。"""),
    code("""
ans = proc.get_answer_for_company("金盘科技", "金盘科技2024年营业收入是多少？", "number")
print("答案:", ans["final_answer"])
print("引用页:", [(r["pdf_sha1"], r["page_index"]) for r in ans["references"]])
print("耗时:", {k: round(v, 3) for k, v in ans.get("timing", {}).items()})
"""),
    md("""## 多轮对话

把历史 (question, answer) 传入 `conversation_history`，上下文化改写由
LLM 完成（离线 stub 直接拼接）——reference
`src/questions_processing.py:988-1019`。"""),
    code("""
history = [{"question": "金盘科技2024年营业收入是多少？",
            "answer": str(ans["final_answer"])}]
follow = proc.get_answer_for_company(
    "金盘科技", "那2023年呢？", "number", conversation_history=history)
print("追问答案:", follow["final_answer"])
"""),
    md("""## 切换检索算法

四种方法同一套 jitted 基础设施：`basic` / `ssg`（贪心图遍历）/
`triangulation`（质心评分）/ `hybrid_expansion`（top-50 + SSG×10 + Tri×20，
带 algorithm_contribution 统计）。遍历的逐跳细节在
`retrieval_details`。"""),
    code("""
import copy
p2 = copy.copy(proc)   # 共享索引/引擎，仅换配置
p2.config = dataclasses.replace(proc.config, retrieval_method="hybrid_expansion")
ans_h = p2.get_answer_for_company("金盘科技", "金盘科技2024年营业收入是多少？", "number")
contrib = ans_h.get("algorithm_contribution") or {}
print("basic:", contrib.get("basic_retrieval_count"),
      "| ssg 新增:", contrib.get("ssg_new_chunks_count"),
      "| tri 新增:", contrib.get("triangulation_new_chunks_count"))
"""),
    md("""## 指定年份 / 上游页面组扩充

`selected_years` 做年份路由（掩码，不是换索引文件）；
`expand_upstream=True` 时取 top-K 核心页 ±N 页做组上下文
（token 预估 ≈ K·(2N+1)·800，webapp 侧边栏实时显示）。"""),
    code("""
ans_y = proc.get_answer_for_company(
    "金盘科技", "金盘科技2023年研发费用是多少？", "number", selected_years=[2023])
print("2023 限定:", ans_y["final_answer"])
"""),
]


def write_notebooks() -> list[Path]:
    out_dir = REPO / "jupyter"
    out_dir.mkdir(exist_ok=True)
    paths = []
    for name, cells in [("end_to_end.ipynb", END_TO_END),
                        ("val_online.ipynb", VAL_ONLINE)]:
        p = out_dir / name
        p.write_text(json.dumps(notebook(cells), ensure_ascii=False, indent=1))
        paths.append(p)
    return paths


def check(paths: list[Path]) -> None:
    """Execute every code cell top-to-bottom in a scratch copy of the demo
    set (no jupyter needed — cells are plain Python in one namespace)."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        scratch = Path(td) / "test_set"
        shutil.copytree(REPO / "data" / "test_set", scratch)
        # notebooks honour RAG_ROOT; keep artifacts out of the repo
        import os

        os.environ["RAG_ROOT"] = str(scratch)
        os.environ["RAGTPU_AUTO_PRETRAIN"] = "0"
        os.chdir(REPO)
        # a kernel launched from the repo root has cwd on sys.path
        if str(REPO) not in sys.path:
            sys.path.insert(0, str(REPO))
        for p in paths:
            ns: dict = {}
            nb = json.loads(p.read_text())
            for i, cell in enumerate(nb["cells"]):
                if cell["cell_type"] != "code":
                    continue
                src = "".join(cell["source"])
                try:
                    exec(compile(src, f"{p.name}:cell{i}", "exec"), ns)
                except Exception:
                    print(f"FAILED {p.name} cell {i}:\n{src}", file=sys.stderr)
                    raise
            print(f"{p.name}: all code cells executed OK")


if __name__ == "__main__":
    paths = write_notebooks()
    print("wrote:", *[str(p) for p in paths])
    if "--check" in sys.argv:
        check(paths)
